"""The port's primitives (``sod_tpu_torch.ops``) against ``sod_tpu.ops`` on
the same numpy inputs, in f32: linear, LayerNorm, MLPs, the two attention
call sites (masked and unmasked) and the bilinear/bicubic resizes.

Tolerance: 1e-5 absolute.  Both sides are f32 with the same rounding
points; only the order of f32 sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.ops import attention as jatt
from sod_tpu.ops import layers as jl
from sod_tpu.ops import resize as jr
from sod_tpu_torch.ops import attention as tatt
from sod_tpu_torch.ops import layers as tl
from sod_tpu_torch.ops import resize as tr

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _check(ours, theirs):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=TOL, rtol=0)


def _linear(p):
    """A port Linear holding a sod_tpu (in, out) linear."""
    w = np.asarray(p["w"])
    lin = tl.Linear(w.shape[0], w.shape[1])
    lin.load_state_dict({"weight": _t(w.T), "bias": _t(p["b"])})
    return lin


def _lin_params(rng, n_in, n_out, bias=True):
    p = {"w": rng.randn(n_in, n_out).astype(np.float32) * 0.3}
    if bias:
        p["b"] = rng.randn(n_out).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    x = rng.randn(2, 5, 16).astype(np.float32)
    p = _lin_params(rng, 16, 8, bias)
    _check(tl.linear(_t(x), _t(p["w"].T), _t(p["b"]) if bias else None),
           jl.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(rng, eps):
    x = rng.randn(3, 7, 32).astype(np.float32) * 3 + 1
    g, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    _check(tl.layer_norm(_t(x), _t(g), _t(b), eps),
           jl.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
                         jnp.asarray(x), eps=eps))


@pytest.mark.parametrize("activation,dims", [("gelu", [16, 64, 16]),
                                             ("relu", [16, 16, 16, 1])])
def test_mlp_apply(rng, activation, dims):
    x = rng.randn(2, 6, dims[0]).astype(np.float32)
    params = {f"fc{i}": _lin_params(rng, a, b)
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    layers = [_linear(params[f"fc{i}"]) for i in range(len(params))]
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in params.items()}
    _check(tl.mlp_apply(layers, _t(x), activation),
           jl.mlp_apply(jp, jnp.asarray(x), activation=activation))


def _key_mask(rng, b, n, masked):
    if not masked:
        return None
    m = rng.rand(b, n) > 0.4
    m[:, 0] = True
    return m


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_qkv(rng, masked):
    b, n, d, h = 2, 9, 32, 4
    x = rng.randn(b, n, d).astype(np.float32)
    params = {"qkv": _lin_params(rng, d, 3 * d), "proj": _lin_params(rng, d, d)}
    km = _key_mask(rng, b, n, masked)
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in params.items()}
    theirs = jatt.self_attention_qkv(
        jp, jnp.asarray(x), h, key_mask=None if km is None else jnp.asarray(km))
    ours = tatt.self_attention_qkv(
        _linear(params["qkv"]), _linear(params["proj"]), _t(x), h,
        key_mask=None if km is None else torch.from_numpy(km))
    _check(ours, theirs)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(rng, masked):
    b, nq, nk, d, h = 2, 5, 11, 32, 4
    q = rng.randn(b, nq, d).astype(np.float32)
    k = rng.randn(b, nk, d).astype(np.float32)
    v = rng.randn(b, nk, d).astype(np.float32)
    in_proj = _lin_params(rng, d, 3 * d)
    out_proj = _lin_params(rng, d, d)
    km = _key_mask(rng, b, nk, masked)
    jp = {"in_proj": {kk: jnp.asarray(vv) for kk, vv in in_proj.items()},
          "out_proj": {kk: jnp.asarray(vv) for kk, vv in out_proj.items()}}
    theirs = jatt.multi_head_attention(
        jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
        key_mask=None if km is None else jnp.asarray(km))
    mha = tatt.MultiheadAttention(d, h)
    mha.load_state_dict({"in_proj_weight": _t(in_proj["w"].T),
                         "in_proj_bias": _t(in_proj["b"]),
                         "out_proj.weight": _t(out_proj["w"].T),
                         "out_proj.bias": _t(out_proj["b"])})
    ours = mha(_t(q), _t(k), _t(v),
               key_mask=None if km is None else torch.from_numpy(km))
    _check(ours, theirs)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size_in,size_out", [((7, 9), (14, 18)),
                                              ((28, 28), (5, 3))])
def test_resize(rng, mode, size_in, size_out):
    x = rng.randn(2, 3, *size_in).astype(np.float32)
    ours = {"bilinear": tr.interpolate_bilinear,
            "bicubic": tr.interpolate_bicubic}[mode](_t(x), *size_out)
    theirs = {"bilinear": jr.interpolate_bilinear,
              "bicubic": jr.interpolate_bicubic}[mode](jnp.asarray(x), *size_out)
    _check(ours, theirs)
