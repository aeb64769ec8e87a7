"""The port's int8 (W8A8) ViT block (``sod_tpu_torch.ops.fused_block_int8``)
against ``sod_tpu``'s, on the same numpy weights and inputs.

* The quantiser: int8 codes, f32 scales, biases and LayerNorm parameters
  exactly equal to ``quantize_vit_blocks``'s through
  ``models.convert.blocks_q_from_jax``; ``quant_rows`` and ``qdot`` exactly
  equal to ``_quant_rows`` and ``_qdot`` run eagerly.
* The plain block against ``xla_int8_block`` and against the Pallas kernel K8
  in interpret mode, unmasked, masked and at d = 768.  Both sides round at
  the same points; an f32 LayerNorm or GELU value that differs in its last
  bit can land on the other side of a .5 code boundary and move one product
  by one code step, and inside ``jit`` XLA computes ``amax / 127`` as a
  product with f32(1/127), which is another f32 for ~4% of the rows.  Reached
  here (``sod_tpu``'s own test takes atol 2e-2, rtol 1e-2): against the twin
  every output within one bf16 ulp (atol 2^-7 at |x| < 2, rtol 2^-7) and at
  most 2% of the outputs differing at all (1.2% at d = 768, <= 0.05% at
  d = 128); against the interpreted kernel the same at d = 128.  At d = 768
  the jit-compiled interpreted kernel departs from ``sod_tpu``'s own eager
  twin in 37% of the outputs (0.03%, 0.8% and 1% at d 384, 256 and 512;
  also with ``xla_allow_excess_precision`` off), 23 of 76800 by more than
  that bound and the worst by 0.0137, while the port stays on the twin: that
  case takes ``sod_tpu``'s own tolerance.
* ``vit_apply(fused=True)`` with quantised blocks against ``sod_tpu``'s routed
  int8 scan (K8 interpreted, ``fused_available`` patched), ``all_layers``
  both ways: within two bf16 ulps after two blocks and the final LayerNorm.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod_tpu.ops.fused_block as jax_fused_block
import sod_tpu.ops.fused_block_int8 as jq
from sod_tpu.models import vit as jax_vit
from sod_tpu_torch.models import vit as port_vit
from sod_tpu_torch.models.convert import blocks_q_from_jax, vit_blocks_from_jax
from sod_tpu_torch.ops import fused_block_int8 as fq

ATOL, RTOL, MAX_DIFF_SHARE = 2.0 ** -7, 2.0 ** -7, 2e-2
needs_pltpu = pytest.mark.skipif(not jq._HAS_PLTPU,
                                 reason="pallas tpu backend unavailable")


def _blocks(rng, d, depth, hidden=None):
    """Stacked ``sod_tpu`` encoder-block params (numpy f32), every leaf
    random so that no bias or LayerNorm parameter can hide."""
    hidden = hidden or 4 * d
    r = lambda *s, sc=0.02: (rng.randn(depth, *s) * sc).astype(np.float32)
    return {"norm1": {"scale": 1 + r(d, sc=0.1), "bias": r(d, sc=0.1)},
            "attn": {"qkv": {"w": r(d, 3 * d), "b": r(3 * d)},
                     "proj": {"w": r(d, d), "b": r(d)}},
            "norm2": {"scale": 1 + r(d, sc=0.1), "bias": r(d, sc=0.1)},
            "mlp": {"fc0": {"w": r(d, hidden), "b": r(hidden)},
                    "fc1": {"w": r(hidden, d), "b": r(d)}}}


def _port_state(blocks, prefix="encoder.blocks."):
    """The stacked blocks as the port's state dict (numpy, (out, in))."""
    return vit_blocks_from_jax(blocks, prefix)


def _jax_quantized(blocks):
    return jq.quantize_vit_blocks(jax.tree.map(jnp.asarray, blocks))


def _one(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


def _assert_close(got, ref, atol=ATOL, rtol=RTOL, share=MAX_DIFF_SHARE):
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    assert np.mean(got != ref) <= share


# ------------------------------------------------------------- the quantiser

@pytest.mark.parametrize("d,depth", [(128, 2), (192, 1), (768, 1)])
def test_quantizer_equals_sod_tpus(rng, d, depth):
    blocks = _blocks(rng, d, depth)
    theirs = blocks_q_from_jax(jax.tree.map(np.asarray, _jax_quantized(blocks)))
    ours = fq.quantize_vit_blocks(_port_state(blocks))
    assert len(ours) == len(theirs) == depth
    for a, b in zip(ours, theirs):
        for name in fq.MATS:
            assert a[name]["q"].dtype == torch.int8 and a[name]["s"].dtype == torch.float32
            for leaf in ("q", "s", "b"):
                assert a[name][leaf].shape == b[name][leaf].shape, (name, leaf)
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)
        for name in ("norm1", "norm2"):
            for leaf in ("weight", "bias"):
                assert a[name][leaf].dtype == torch.float32
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)


def test_quantize_weight_roundtrip(rng):
    """q * s rebuilds the weight within half a code of its channel's scale,
    codes stay in [-127, 127], every channel reaches +-127; a zero channel
    takes the scale floor."""
    w = torch.from_numpy((rng.randn(96, 64) * 0.02).astype(np.float32))
    w[3] = 0
    q, s = fq.quantize_weight(w)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (96,)
    assert int(q.abs().max()) == 127 and float(s[3]) == pytest.approx(1e-12)
    assert bool(((q.float() * s[:, None] - w).abs() <= s[:, None] * (0.5 + 1e-5)).all())
    live = torch.arange(96) != 3
    assert bool((q.abs().amax(dim=1)[live] == 127).all())


def test_quantizer_takes_a_module_and_refuses_cast_weights(rng):
    cfg = port_vit.ViTConfig(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
    vit = port_vit.VisionTransformer(cfg)
    blocks = _blocks(rng, 64, 2)
    state = _port_state(blocks, "blocks.")
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False)
    fq.vit_quantize_int8(vit)
    from_state = fq.quantize_vit_blocks(state, prefix="blocks.")
    for a, b in zip(vit.blocks_q, from_state):
        assert all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])
    vit.to(torch.bfloat16)                     # the records are no parameters
    assert vit.blocks_q[0]["qkv"]["s"].dtype == torch.float32
    with pytest.raises(ValueError, match="f32"):
        fq.quantize_vit_blocks(vit)
    with pytest.raises(ValueError, match="no encoder blocks"):
        fq.quantize_vit_blocks(state)          # the default prefix is the model's


@pytest.mark.parametrize("shape", [(7, 64), (2, 128, 384), (3, 1536)])
def test_quant_rows_equals_sod_tpus(rng, shape):
    h = rng.randn(*shape).astype(np.float32) * np.exp(rng.randn(*shape[:-1], 1)
                                                      ).astype(np.float32)
    h.reshape(-1, shape[-1])[0] = 0                                   # the amax floor
    ties = (np.arange(shape[-1]) % 250 - 125 + 0.5).astype(np.float32)
    ties[0] = 127                                                     # scale 1: exact .5 ties
    h.reshape(-1, shape[-1])[1] = ties
    qj, sj = jq._quant_rows(jnp.asarray(h))                           # eager: true divisions
    qt, st = fq.quant_rows(torch.from_numpy(h))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert qt.reshape(-1, shape[-1])[1, 1:5].tolist() == [-124, -122, -122, -120]


@pytest.mark.parametrize("k,n", [(64, 96), (1536, 384)])
def test_qdot_equals_sod_tpus(rng, k, n):
    """The integer product is exact on both sides (|acc| passes 2^24 at
    K = 1536), so the dequantised f32 values are equal bit for bit."""
    h = (rng.randn(40, k) * 3).astype(np.float32)
    h[0] = np.abs(h[0]).max()                   # a row of full-scale codes
    w = rng.randn(k, n).astype(np.float32)
    w[:, 0] = np.abs(w[:, 0])
    wq, ws = jq._quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq._qdot(jnp.asarray(h), wq, ws))
    tq, ts = fq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = fq.qdot(torch.from_numpy(h), tq, ts).numpy()
    assert np.abs(np.asarray(jnp.asarray(h @ w))).max() > 0 and np.array_equal(got, ref)


# ----------------------------------------------------------------- the block

def _block_inputs(rng, d, n_heads, masked, b=2, n_pad=128, n_real=100):
    blocks = _blocks(rng, d, 1)
    bq_j = _one(_jax_quantized(blocks))
    bq_t = fq.quantize_vit_blocks(_port_state(blocks))[0]
    x = rng.randn(b, n_pad, d).astype(np.float32)
    x[:, n_real:] = 0
    km = None
    if masked:
        km = rng.rand(b, n_pad) > 0.4
        km[:, 0] = True
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return bq_j, bq_t, xj, xt, km


CASES = [("unmasked", 128, 2, False), ("masked", 128, 2, True), ("d768", 768, 12, False)]


@pytest.mark.parametrize("name,d,n_heads,masked", CASES, ids=[c[0] for c in CASES])
def test_plain_block_matches_xla_twin(rng, name, d, n_heads, masked):
    bq_j, bq_t, xj, xt, km = _block_inputs(rng, d, n_heads, masked)
    ref = jq.xla_int8_block(xj, bq_j, n_heads, n_real=100,
                            key_mask=None if km is None else jnp.asarray(km))
    got = fq.fused_vit_block_int8_reference(
        xt, bq_t, n_heads, 100, key_mask=None if km is None else torch.from_numpy(km))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    rows = np.ones((2, 128), bool) if km is None else km
    rows = rows & (np.arange(128) < 100)
    _assert_close(_f32(got)[rows], _f32(ref)[rows])


@needs_pltpu
@pytest.mark.parametrize("name,d,n_heads,masked", CASES, ids=[c[0] for c in CASES])
def test_plain_block_matches_interpret_kernel(rng, name, d, n_heads, masked):
    bq_j, bq_t, xj, xt, km = _block_inputs(rng, d, n_heads, masked,
                                           b=1 if d == 768 else 2)
    ref = jq.fused_vit_block_int8(xj, bq_j, n_heads, n_real=100, interpret=True,
                                  key_mask=None if km is None else jnp.asarray(km))
    got = fq.fused_vit_block_int8(
        xt, bq_t, n_heads, 100, key_mask=None if km is None else torch.from_numpy(km))
    rows = np.ones(tuple(xt.shape[:2]), bool) if km is None else km
    rows = rows & (np.arange(128) < 100)
    tol = dict(atol=2e-2, rtol=1e-2, share=0.5) if d == 768 else {}
    _assert_close(_f32(got)[rows], _f32(ref)[rows], **tol)


def test_sod_tpus_record_runs_in_the_ports_block(rng):
    """``blocks_q_from_jax`` carries ``sod_tpu``'s own quantised blocks into
    the port's block: the same output as from the port's quantiser."""
    bq_j, bq_t, _, xt, _ = _block_inputs(rng, 128, 2, False)
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], bq_j)
    carried = blocks_q_from_jax(stacked)[0]
    assert torch.equal(fq.fused_vit_block_int8(xt, carried, 2, 100),
                       fq.fused_vit_block_int8(xt, bq_t, 2, 100))


def test_wrapper_runs_plain_version_on_cpu_and_fills_scratch(rng):
    _, bq, _, xt, _ = _block_inputs(rng, 128, 2, False)
    before, scratch = fq.launches, {}
    got = fq.fused_vit_block_int8(xt, bq, 2, 100, scratch=scratch)
    assert torch.equal(got, fq.fused_vit_block_int8_reference(xt, bq, 2, 100))
    assert fq.launches == before               # no kernel was launched
    assert scratch["q_fc2"].shape == (256, 512) and scratch["q_fc2"].dtype == torch.int8
    assert scratch["s_qkv"].shape == (256,) and scratch["hid"].dtype == torch.float32
    assert scratch["x1"].dtype == torch.float32 and scratch["qkv"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["n_pad_above_1024", "d_above_768", "no_cuda_device",
                                  "n_pad_not_128", "float32", "non_contiguous",
                                  "key_mask_shape", "head_dim", "record_of_another_width"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, case):
    d, n_heads, n = 128, 2, 128
    if case == "d_above_768":
        d, n_heads = 832, 13
    bq = fq.quantize_vit_blocks(_port_state(_blocks(rng, d, 1, hidden=128)))[0]
    if case == "record_of_another_width":
        bq = fq.quantize_vit_blocks(_port_state(_blocks(rng, 64, 1)))[0]
    if case == "n_pad_above_1024":
        n = 1152
    elif case == "n_pad_not_128":
        n = 120
    x = torch.zeros(1, n, d, dtype=torch.bfloat16)
    kw = {}
    if case == "no_cuda_device":
        x = x.to("meta")
    elif case == "float32":
        x = x.float()
    elif case == "non_contiguous":
        x = torch.zeros(1, d, n, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "key_mask_shape":
        kw["key_mask"] = torch.ones(1, n - 1, dtype=torch.bool)
    elif case == "head_dim":
        n_heads = 8                            # head dim 16: no kernel built for it
    with pytest.raises(ValueError):
        fq.fused_vit_block_int8(x, bq, n_heads, 100, **kw)


# -------------------------------------------------------------- the encoder

SMALL = dict(patch_size=8, embed_dim=128, depth=2, n_heads=2, pos_grid=4)


def _encoders(rng):
    """The same encoder on both sides: ``vit_init`` with random blocks."""
    jcfg = jax_vit.ViTConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax_vit.vit_init(jax.random.key(0), jcfg))
    params["blocks"] = _blocks(rng, 128, 2)
    params["norm"] = {"scale": (1 + rng.randn(128) * 0.1).astype(np.float32),
                      "bias": (rng.randn(128) * 0.1).astype(np.float32)}
    vit = port_vit.VisionTransformer(port_vit.ViTConfig(**SMALL))
    pw = params["patch_embed"]["w"]
    state = _port_state(params["blocks"], "blocks.")
    state.update({"patch_embed.proj.weight": np.ascontiguousarray(
                      pw.reshape(8, 8, 3, 128).transpose(3, 2, 0, 1)),
                  "patch_embed.proj.bias": params["patch_embed"]["b"],
                  "cls_token": params["cls_token"], "pos_embed": params["pos_embed"],
                  "norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"]})
    vit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return jcfg, params, vit.eval()


@pytest.fixture()
def interpret_k8(monkeypatch):
    """sod_tpu's int8 route on the CPU: K8 in interpret mode (``vit_apply``
    imports both names at call time)."""
    calls = []

    def interp(*a, **kw):
        calls.append(1)
        return real(*a, interpret=True, **kw)

    real = jq.fused_vit_block_int8
    monkeypatch.setattr(jax_fused_block, "fused_available", lambda: True)
    monkeypatch.setattr(jq, "fused_vit_block_int8", interp)
    return calls


@needs_pltpu
@pytest.mark.parametrize("all_layers", [False, True])
def test_vit_apply_int8_matches_sod_tpu(rng, interpret_k8, all_layers):
    jcfg, params, vit = _encoders(rng)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    pq = jq.vit_quantize_int8(jax.tree.map(jnp.asarray, params))     # from f32
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                       {k: v for k, v in pq.items() if k != "blocks_q"})
    p16["blocks_q"] = pq["blocks_q"]
    ref = jax_vit.vit_apply(p16, jnp.asarray(x).astype(jnp.bfloat16), jcfg,
                            all_layers=all_layers, fused=True)
    assert len(interpret_k8) >= 1

    fq.vit_quantize_int8(vit)                                         # from f32
    vit16 = vit.to(torch.bfloat16)
    before = fq.launches
    with torch.no_grad():
        got = port_vit.vit_apply(vit16, torch.from_numpy(x).to(torch.bfloat16),
                                 fused=True, all_layers=all_layers)
    assert fq.launches == before and got.dtype == torch.bfloat16
    assert got.shape == ref.shape == ((2, 2, 17, 128) if all_layers else (2, 17, 128))
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=2 * ATOL, rtol=2 * RTOL)
    if all_layers:
        with torch.no_grad():
            last = port_vit.vit_apply(vit16, torch.from_numpy(x).to(torch.bfloat16), fused=True)
        assert torch.equal(got[-1], last)


def _route(monkeypatch, vit, x):
    """Which kernels ``vit_apply(fused=True)`` calls for ``x``."""
    calls = []
    for name in ("fused_vit_block", "fused_vit_block_int8", "fused_ln_attn_infer",
                 "fused_ln_mlp"):
        def spy(t, *a, _name=name, **kw):
            calls.append(_name)
            return t
        monkeypatch.setattr(port_vit, name, spy)
    with torch.no_grad():
        port_vit.vit_apply(vit, x, fused=True)
    return calls


@pytest.mark.parametrize("d,n_heads,side,quantised,want", [
    (128, 2, 32, True, ["fused_vit_block_int8"]),
    (128, 2, 32, False, ["fused_vit_block"]),
    (768, 12, 16, True, ["fused_vit_block_int8"]),
    (768, 12, 16, False, ["fused_ln_attn_infer", "fused_ln_mlp"]),
    (128, 2, 272, True, ["fused_ln_attn_infer", "fused_ln_mlp"]),     # 1157 tokens
])
def test_vit_apply_routes_as_sod_tpu(monkeypatch, d, n_heads, side, quantised, want):
    """``sod_tpu/models/vit.py:323-389``: the whole-block kernel up to 1024
    padded tokens, K8 up to d 768 with quantised blocks and K1 up to d 512
    without; anything else K5 then K4 on the float weights."""
    cfg = port_vit.ViTConfig(patch_size=8, embed_dim=d, depth=1, n_heads=n_heads, pos_grid=2)
    vit = port_vit.VisionTransformer(cfg)
    for p in vit.parameters():
        torch.nn.init.normal_(p, std=0.02)
    if quantised:
        fq.vit_quantize_int8(vit)
    x = torch.zeros(1, side, side, 3, dtype=torch.bfloat16)
    assert _route(monkeypatch, vit.to(torch.bfloat16), x) == want


def test_f32_tokens_ignore_the_quantised_blocks(rng):
    _, _, vit = _encoders(rng)
    x = torch.from_numpy(rng.rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        ref = port_vit.vit_apply(vit, x, fused=True)
        fq.vit_quantize_int8(vit)
        assert torch.equal(port_vit.vit_apply(vit, x, fused=True), ref)


@pytest.mark.parametrize("name", ["vit_tiny", "vit_small", "vit_base"])
def test_vit_configs_equal_sod_tpus(name):
    ours, theirs = getattr(port_vit, name)(), getattr(jax_vit, name)()
    for field in ("patch_size", "embed_dim", "depth", "n_heads", "pos_grid", "use_flash"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert getattr(port_vit, name)(patch_size=8).pos_grid == 28
