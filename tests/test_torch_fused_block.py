"""The port's fused ViT block (``sod_tpu_torch.ops.fused_block``).

On the CPU the wrapper runs the kernel's plain version, held here against
``sod_tpu``'s Pallas kernel K1 in interpret mode on the same bf16 inputs
and weights (random biases and LayerNorm parameters, so none can hide).
Both round at the same points, so they agree to the last bf16 bit except
where an f32 sum taken in another order rounds the other way: tolerance
1e-2 absolute plus one bf16 ulp (2^-7) relative, correlation > 0.9999.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (the card's machine has no jax, which every test here
imports).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.ops.fused_block import fused_vit_block as jax_fused_vit_block
from sod_tpu_torch.models.vit import Block, ViTConfig
from sod_tpu_torch.ops import fused_block as fb

D, H, HIDDEN = 128, 2, 512
N_REAL, N_PAD = 100, 128
ATOL, RTOL, MIN_CORR = 1e-2, 2.0 ** -7, 0.9999


def _jax_block(rng):
    r = lambda *s, sc=0.02: (rng.randn(*s) * sc).astype(np.float32)
    return {"norm1": {"scale": 1 + r(D, sc=0.1), "bias": r(D, sc=0.1)},
            "attn": {"qkv": {"w": r(D, 3 * D), "b": r(3 * D)},
                     "proj": {"w": r(D, D), "b": r(D)}},
            "norm2": {"scale": 1 + r(D, sc=0.1), "bias": r(D, sc=0.1)},
            "mlp": {"fc0": {"w": r(D, HIDDEN), "b": r(HIDDEN)},
                    "fc1": {"w": r(HIDDEN, D), "b": r(D)}}}


def _port_block(bp):
    blk = Block(ViTConfig(embed_dim=D, n_heads=H, depth=1, pos_grid=4))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lin = lambda p, name: {f"{name}.weight": t(p["w"].T), f"{name}.bias": t(p["b"])}
    ln = lambda p, name: {f"{name}.weight": t(p["scale"]), f"{name}.bias": t(p["bias"])}
    blk.load_state_dict({**ln(bp["norm1"], "norm1"), **ln(bp["norm2"], "norm2"),
                         **lin(bp["attn"]["qkv"], "attn.qkv"),
                         **lin(bp["attn"]["proj"], "attn.proj"),
                         **lin(bp["mlp"]["fc0"], "mlp.fc1"),
                         **lin(bp["mlp"]["fc1"], "mlp.fc2")})
    return blk.to(torch.bfloat16)


def _inputs(rng, masked):
    x = jnp.asarray(rng.randn(2, N_PAD, D).astype(np.float32)).astype(jnp.bfloat16)
    km = None
    if masked:
        km = rng.rand(2, N_PAD) > 0.3
        km[:, 0] = True
    return x, km


@pytest.mark.parametrize("masked", [False, True])
def test_plain_version_matches_interpret_kernel(rng, masked):
    bp = _jax_block(rng)
    x, km = _inputs(rng, masked)
    ref = jax_fused_vit_block(x, jax.tree.map(jnp.asarray, bp), H, n_real=N_REAL,
                              interpret=True,
                              key_mask=None if km is None else jnp.asarray(km))
    ref = np.asarray(ref.astype(jnp.float32))[:, :N_REAL]
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = fb.fused_vit_block_reference(
            xt, _port_block(bp), H, N_REAL,
            key_mask=None if km is None else torch.from_numpy(km))
    got = got.float().numpy()[:, :N_REAL]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > MIN_CORR


def test_wrapper_runs_plain_version_on_cpu(rng):
    bp = _jax_block(rng)
    blk = _port_block(bp)
    x = torch.from_numpy(rng.randn(1, N_PAD, D).astype(np.float32)).to(torch.bfloat16)
    before = fb.launches
    with torch.no_grad():
        got = fb.fused_vit_block(x, blk, H, N_REAL)
        ref = fb.fused_vit_block_reference(x, blk, H, N_REAL)
    assert torch.equal(got, ref) and got.dtype == torch.bfloat16
    assert fb.launches == before            # no kernel was launched


@pytest.mark.parametrize("case", ["non_contiguous", "n_pad_not_128", "float32",
                                  "key_mask_shape", "head_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, case):
    blk = _port_block(_jax_block(rng))
    x = torch.zeros(1, N_PAD, D, dtype=torch.bfloat16)
    kw = {}
    n_heads = H
    if case == "non_contiguous":
        x = torch.zeros(1, D, N_PAD, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "n_pad_not_128":
        x = torch.zeros(1, 120, D, dtype=torch.bfloat16)
    elif case == "float32":
        x = x.float()
    elif case == "key_mask_shape":
        kw["key_mask"] = torch.ones(1, N_PAD - 1, dtype=torch.bool)
    elif case == "head_dim":
        n_heads = 8                          # head dim 16: no kernel built for it
    with pytest.raises(ValueError):
        fb.fused_vit_block(x, blk, n_heads, N_REAL, **kw)

