"""The backward products of K3 and K4 and their LayerNorm backward, alone
(``sod_tpu_torch.ops.gemm``: ``gemm_nn``, ``gemm_tn``, ``ln_backward``).

On the CPU each entry runs its plain version.  Held here, on bf16-valued
inputs made with numpy:

* each plain form against ``sod_tpu``'s own math for it, the
  ``jax.lax.dot_general(..., preferred_element_type=f32)`` calls of the
  Pallas backward kernels' bodies (``sod_tpu/ops/fused_attn.py``
  ``_bwd_kernel``, ``sod_tpu/ops/fused_mlp.py`` ``_bwd_kernel``) in
  ``sod_tpu``'s (in, out) weight layout: f32 outputs within 1e-4 of the
  output's magnitude (f32 sums in another order), bf16 outputs within one
  bf16 ulp at the output's magnitude (one rounding flip);
* the forms, with the LayerNorm backward, compose to the chains' plain
  versions ``fused_ln_attn_backward_reference`` (every save mode) and
  ``fused_ln_mlp_backward_reference`` (both variants) bit for bit: they
  round at the same points and run the same products;
* the entries run their plain version for a CPU tensor, count no launch,
  and reject what the kernels do not take (shape multiples, dtypes, a
  device without a kernel).

``chip_smoke.py`` (phase 3) holds the CUDA kernels against these plain
versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.ops import fused_mlp as jax_mlp
from sod_tpu_torch.ops import fused_attn as fattn
from sod_tpu_torch.ops import fused_mlp as fmlp
from sod_tpu_torch.ops import gemm as G
from sod_tpu_torch.ops.fused_mlp import _gelu_tanh, _ln_pieces

BF16 = torch.bfloat16
F32 = jnp.float32
EPS = 1e-6
# the small widths: rows, d, hidden
M, D, H = 192, 128, 256


def _bf16_np(rng, *shape, scale=1.0, offset=0.0):
    """f32 numpy values that bf16 represents exactly."""
    a = torch.from_numpy((offset + rng.standard_normal(shape) * scale).astype(np.float32))
    return a.to(BF16).float().numpy()


def _t(a, dtype=BF16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _dot(a, b, dims):
    """``sod_tpu``'s products: bf16 operands, f32 accumulation."""
    return np.asarray(jax.lax.dot_general(a, b, (dims, ((), ())),
                                          preferred_element_type=F32))


def _f32_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _bf16_close(got, want):
    """Within one bf16 ulp at the output's magnitude (its largest value):
    one rounding flip of an element.  (A da whose gelu'(a) is near zero
    moves by more than its own ulp with an f32 difference in a, and stays
    far below this one.)"""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(F32))
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(w).max()))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w)) / ulp)


# ---------------------------------------------------------------------------
# each form against sod_tpu's math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["k3_dattn", "k3_dh", "k4_dh"])
def test_nn_form_matches_sod_tpu_math(form):
    """dattn = bf16(gc . Wproj^T) (``_bwd_kernel``: contract gc's columns with
    Wproj's output dim), dh = dqkv . Wqkv^T and dh = bf16(da) . W1^T, f32;
    the port reads each weight in its (out, in) layout untransposed."""
    rng = np.random.default_rng(10)
    k, n = {"k3_dattn": (D, D), "k3_dh": (3 * D, D), "k4_dh": (H, D)}[form]
    a = _bf16_np(rng, M, k, scale=0.5)
    w_sod = _bf16_np(rng, n, k, scale=0.05)          # sod_tpu's (in, out): in = n, out = k
    want = _dot(_j(a), _j(w_sod), ((1,), (1,)))
    got = G.gemm_nn(_t(a), _t(w_sod.T), "bf16" if form == "k3_dattn" else "f32")
    if form == "k3_dattn":
        assert got.dtype == BF16
        _bf16_close(got, want)
    else:
        assert got.dtype == torch.float32
        _f32_close(got, want)


@pytest.mark.parametrize("kept", [False, True])
def test_dgelu_form_matches_sod_tpu_math(kept):
    """K4's dg = dyc . W2^T with the GELU gradient: da = dg * gelu'(a), bf16
    da, bf16 gel = gelu(a), db1 = the column sums of the f32 da; ``a`` the
    f32 recompute h . W1 + b1 (``_bwd_kernel``, here inside the kernel) or
    the kept bf16 hidden (``_bwd_kernel_saved``)."""
    rng = np.random.default_rng(11)
    dy = _bf16_np(rng, M, D, scale=0.5)
    w2_sod = _bf16_np(rng, H, D, scale=0.05)          # fc2: (in, out) = (H, D)
    h = _bf16_np(rng, M, D)
    w1_sod = _bf16_np(rng, D, H, scale=0.1)           # fc1: (in, out) = (D, H)
    b1 = _bf16_np(rng, H, scale=0.1)
    a = _dot(_j(h), _j(w1_sod), ((1,), (0,))) + b1
    if kept:
        a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(F32))
    dg = _dot(_j(dy), _j(w2_sod), ((1,), (1,)))
    ja = jnp.asarray(a)
    da = dg * jax_mlp._gelu_tanh_grad(ja)
    gel = jax_mlp._gelu_tanh(ja)
    pre = _t(a) if kept else (_t(h), _t(w1_sod.T), _t(b1))
    got_da, got_gel, got_db = G.gemm_nn(_t(dy), _t(w2_sod.T), "dgelu", pre)
    assert got_da.dtype == got_gel.dtype == BF16 and got_db.dtype == torch.float32
    _bf16_close(got_da, da)
    _bf16_close(got_gel, gel)
    _f32_close(got_db, jnp.sum(da, axis=0))


@pytest.mark.parametrize("form", ["k3_dwproj", "k3_dwqkv", "k4_dw2", "k4_dw1"])
def test_tn_form_matches_sod_tpu_math(form):
    """The weight gradients contract the rows: dWproj = attn^T . gc,
    dWqkv = h^T . dqkv, dW2 = gel^T . dyc, dW1 = h^T . bf16(da), each
    [in, out] in ``sod_tpu``; the port's gemm_tn(g, x) = g^T . x is the
    same sum in its (out, in) layout."""
    rng = np.random.default_rng(12)
    out_w, in_w = {"k3_dwproj": (D, D), "k3_dwqkv": (3 * D, D), "k4_dw2": (D, H),
                   "k4_dw1": (H, D)}[form]
    g = _bf16_np(rng, M, out_w, scale=0.5)             # the output side's gradient
    x = _bf16_np(rng, M, in_w, scale=0.5)              # the input side's activations
    want = _dot(_j(x), _j(g), ((0,), (0,)))            # [in, out]
    got = G.gemm_tn(_t(g), _t(x))
    assert got.dtype == torch.float32 and got.shape == (out_w, in_w)
    _f32_close(got, want.T)


def test_ln_backward_matches_sod_tpu_math():
    """The LayerNorm backward + residual of both Pallas backward kernels:
    xhat from f32 mean and variance, dls = sum dh xhat, dlb = sum dh,
    dx = bf16(g + inv (dxhat - mean dxhat - xhat mean(dxhat xhat))), and
    the output bias's gradient sum g."""
    rng = np.random.default_rng(13)
    x = _bf16_np(rng, M, D, scale=2.0, offset=0.3)
    dh = (rng.standard_normal((M, D)) * 0.05).astype(np.float32)
    g = _bf16_np(rng, M, D, scale=0.5)
    s = _bf16_np(rng, D, scale=0.1, offset=1.0)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    inv = jax.lax.rsqrt(var + EPS)
    xhat = (x - mean) * inv
    dxhat = dh * s
    dx = g + inv * (dxhat - jnp.mean(dxhat, axis=-1, keepdims=True)
                    - xhat * jnp.mean(dxhat * xhat, axis=-1, keepdims=True))
    got = G.ln_backward(_t(x), _t(dh, torch.float32), _t(g), _t(s), EPS)
    assert got[0].dtype == BF16 and all(t.dtype == torch.float32 for t in got[1:])
    _bf16_close(got[0], dx)
    for t, want in zip(got[1:], (jnp.sum(dh * xhat, axis=0), jnp.sum(dh, axis=0),
                                 jnp.sum(g, axis=0))):
        _f32_close(t, want)


# ---------------------------------------------------------------------------
# the forms compose to the chains' plain versions
# ---------------------------------------------------------------------------

def _weights(rng, shapes):
    out = []
    for name, shape in shapes:
        scale, offset = (0.1, 1.0) if name == "ln_w" else (0.05, 0.0)
        out.append(torch.from_numpy(_bf16_np(rng, *shape, scale=scale, offset=offset)))
    return out


@pytest.mark.parametrize("mode", ["nothing kept", "qkv kept", "attn kept"])
def test_forms_compose_to_k3_backward_plain_version(mode):
    """LN rows, the QKV recompute, dattn (NN bf16), the attention backward,
    dWproj and dWqkv (TN), dh (NN f32) and ``ln_backward`` give
    ``fused_ln_attn_backward_reference``'s seven outputs bit for bit."""
    rng = np.random.default_rng(14)
    b, n, n_real, heads = 2, 128, 100, 2
    hd = D // heads
    weights = _weights(rng, [("ln_w", (D,)), ("ln_b", (D,)), ("wqkv", (3 * D, D)),
                             ("bqkv", (3 * D,)), ("wproj", (D, D)), ("bproj", (D,))])
    ln_w, ln_b, wqkv, bqkv, wproj, _ = weights
    x = _t(_bf16_np(rng, b, n, D))
    g = _t(_bf16_np(rng, b, n, D, scale=0.5))
    g[:, n_real:] = 0
    _, _, qkv_f, attn_f = fattn._forward_plain(x, weights, heads, n_real, None, EPS)
    saved = {"qkv kept": {"qkv_saved": qkv_f.to(BF16)},
             "attn kept": {"attn_saved": attn_f.to(BF16)}}.get(mode, {})
    want = fattn.fused_ln_attn_backward_reference(x, g, weights, heads, n_real, EPS, **saved)

    rows = lambda t: t.reshape(b * n, t.shape[-1])  # noqa: E731
    xhat, _ = _ln_pieces(x.float(), ln_w, EPS)
    h = (xhat * ln_w + ln_b).to(BF16)
    qkv = (torch.matmul(h.float(), wqkv.t()) + bqkv).to(BF16).float()
    if "qkv_saved" in saved:
        qkv = saved["qkv_saved"].float()
    dattn = G.gemm_nn(rows(g), wproj.to(BF16), "bf16").float().reshape(b, n, D)
    key_ok = (torch.arange(n) < n_real)[None, :].expand(b, n)
    dqkv = torch.empty_like(qkv)
    dbqkv = torch.empty(3 * D)
    heads_out = []
    for i in range(heads):
        sl = [slice(j * D + i * hd, j * D + (i + 1) * hd) for j in range(3)]
        q, k, v = (qkv[..., s_] for s_ in sl)
        do = dattn[..., i * hd:(i + 1) * hd]
        p = fattn._probs(q, k, hd ** -0.5, key_ok)
        pc = p.to(BF16).float()
        heads_out.append(torch.matmul(pc, v).to(BF16).float())
        dv = torch.matmul(pc.transpose(-1, -2), do)
        dp = torch.matmul(do, v.transpose(-1, -2))
        ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * hd ** -0.5
        dsc = ds.to(BF16).float()
        dq = torch.matmul(dsc, k).to(BF16).float()
        dk = torch.matmul(dsc.transpose(-1, -2), q)
        dqkv[..., sl[0]], dqkv[..., sl[1]], dqkv[..., sl[2]] = (
            dq, dk.to(BF16).float(), dv.to(BF16).float())
        dbqkv[sl[0]], dbqkv[sl[1]], dbqkv[sl[2]] = (
            dq.sum(dim=(0, 1)), dk.sum(dim=(0, 1)), dv.sum(dim=(0, 1)))
    attn = (saved["attn_saved"].float() if "attn_saved" in saved
            else torch.cat(heads_out, dim=-1))
    dqkv16 = rows(dqkv).to(BF16)
    dwproj = G.gemm_tn(rows(g), rows(attn).to(BF16))
    dwqkv = G.gemm_tn(dqkv16, rows(h))
    dh = G.gemm_nn(dqkv16, wqkv.to(BF16), "f32")
    dx, dls, dlb, dbproj = G.ln_backward(rows(x), dh, rows(g), ln_w.to(BF16), EPS)
    got = (dx.reshape(b, n, D), dls, dlb, dwqkv, dbqkv, dwproj, dbproj)
    for name, a, w in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name


@pytest.mark.parametrize("kept", [False, True])
def test_forms_compose_to_k4_backward_plain_version(kept):
    """LN rows, dGELU (NN) with the fc1 recompute inside (or on the kept
    bf16 hidden), dW2 and dW1 (TN), dh (NN f32) and ``ln_backward`` give
    ``fused_ln_mlp_backward_reference``'s seven outputs bit for bit."""
    rng = np.random.default_rng(15)
    weights = _weights(rng, [("ln_w", (D,)), ("ln_b", (D,)), ("w1", (H, D)), ("b1", (H,)),
                             ("w2", (D, H)), ("b2", (D,))])
    ln_w, ln_b, w1, b1, w2, _ = weights
    x = _t(_bf16_np(rng, M, D, scale=2.0))
    dy = _t(_bf16_np(rng, M, D, scale=0.5))
    xhat, _ = _ln_pieces(x.float(), ln_w, EPS)
    h = (xhat * ln_w + ln_b).to(BF16)
    a = torch.matmul(h.float(), w1.t()) + b1
    a_saved = a.to(BF16) if kept else None
    want = fmlp.fused_ln_mlp_backward_reference(x, dy, weights, EPS, a_saved)

    pre = a_saved if kept else (h, w1.to(BF16), b1.to(BF16))
    da, gel, db1 = G.gemm_nn(dy, w2.to(BF16), "dgelu", pre)
    assert torch.equal(gel.float(), _gelu_tanh(a_saved.float() if kept else a).to(BF16).float())
    dw2 = G.gemm_tn(dy, gel)
    dw1 = G.gemm_tn(da, h)
    dh = G.gemm_nn(da, w1.to(BF16), "f32")
    dx, dls, dlb, db2 = G.ln_backward(x, dh, dy, ln_w.to(BF16), EPS)
    got = (dx, dls, dlb, dw1, db1, dw2, db2)
    for name, g_, w_ in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), got, want):
        assert g_.dtype == w_.dtype and torch.equal(g_, w_), name


# ---------------------------------------------------------------------------
# the entries on the CPU, and what they refuse
# ---------------------------------------------------------------------------

def _nn_inputs(rng, epilogue, m=128, n=192, k=64, recompute=False):
    a = _t(_bf16_np(rng, m, k))
    w = _t(_bf16_np(rng, k, n, scale=0.05))
    pre = None
    if epilogue == "dgelu":
        pre = ((_t(_bf16_np(rng, m, k)), _t(_bf16_np(rng, n, k, scale=0.1)),
                _t(_bf16_np(rng, n, scale=0.1))) if recompute
               else _t(rng.standard_normal((m, n)).astype(np.float32)))
    return dict(a=a, w=w, epilogue=epilogue, pre=pre)


@pytest.mark.parametrize("case", ["bf16", "f32", "dgelu_recompute", "dgelu_kept", "tn",
                                  "ln_backward"])
def test_entries_on_cpu_are_the_plain_versions(case):
    """For CPU tensors each entry returns its plain version's result, counts
    no launch, and has the form's dtypes and shapes."""
    rng = np.random.default_rng(16)
    counters = ("launches", "nn_launches", "tn_launches", "ln_bwd_launches")
    before = [getattr(G, c) for c in counters]
    if case == "tn":
        a, b = _t(_bf16_np(rng, 256, 128)), _t(_bf16_np(rng, 256, 64))
        got, want = (G.gemm_tn(a, b),), (G.gemm_tn_reference(a, b),)
        assert got[0].shape == (128, 64) and got[0].dtype == torch.float32
    elif case == "ln_backward":
        args = (_t(_bf16_np(rng, 128, 384)), _t(rng.standard_normal((128, 384)), torch.float32),
                _t(_bf16_np(rng, 128, 384)), _t(_bf16_np(rng, 384, offset=1.0)))
        got, want = G.ln_backward(*args), G.ln_backward_reference(*args)
        assert got[0].dtype == BF16 and got[1].shape == (384,)
    else:
        kw = _nn_inputs(rng, case[:5] if case.startswith("dgelu") else case,
                        recompute=case == "dgelu_recompute")
        got, want = G.gemm_nn(**kw), G.gemm_nn_reference(**kw)
        if case == "f32":
            assert got.dtype == torch.float32
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert got[0].shape == (128, 192)
        if case.startswith("dgelu"):
            assert [t.dtype for t in got] == [BF16, BF16, torch.float32]
            assert got[2].shape == (192,)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert [getattr(G, c) for c in counters] == before


@pytest.mark.parametrize("case", ["epilogue", "rows", "cols", "depth", "chain", "a_dtype",
                                  "w_dtype", "no_pre", "pre_without_dgelu", "pre_shape",
                                  "pre_dtype", "recompute_shape", "recompute_dtype",
                                  "recompute_arity"])
def test_gemm_nn_rejects_what_the_kernel_does_not_take(case):
    """The kept hidden must be bf16 [M, N] (an f32 one is no form of the
    kernel: the hidden is recomputed inside it instead)."""
    rng = np.random.default_rng(17)
    kw = _nn_inputs(rng, "bf16")
    dg = _nn_inputs(rng, "dgelu")
    dg["pre"] = dg["pre"].to(BF16)
    rc = _nn_inputs(rng, "dgelu", recompute=True)
    h, w1, b1 = rc["pre"]
    bad = {
        "epilogue": lambda: dict(kw, epilogue="gelu"),
        "rows": lambda: dict(dg, a=dg["a"][:96], pre=dg["pre"][:96]),    # dgelu: M % 64
        "cols": lambda: dict(kw, w=kw["w"][:, :160]),                    # N % 64
        "depth": lambda: _nn_inputs(rng, "f32", k=48),                   # K % 32
        "chain": lambda: dict(kw, w=kw["w"][:32]),                       # K mismatch
        "a_dtype": lambda: dict(kw, a=kw["a"].float()),
        "w_dtype": lambda: dict(kw, w=kw["w"].float()),
        "no_pre": lambda: dict(dg, pre=None),
        "pre_without_dgelu": lambda: dict(kw, pre=dg["pre"]),
        "pre_shape": lambda: dict(dg, pre=dg["pre"][:64]),
        "pre_dtype": lambda: dict(dg, pre=dg["pre"].float()),
        "recompute_shape": lambda: dict(rc, pre=(h, w1[:, :32], b1)),
        "recompute_dtype": lambda: dict(rc, pre=(h, w1, b1.float())),
        "recompute_arity": lambda: dict(rc, pre=(h, w1)),
    }[case]()
    with pytest.raises(ValueError):
        G.gemm_nn(**bad)


@pytest.mark.parametrize("case", ["rows_differ", "rows", "ka", "nb", "dtype", "rank"])
def test_gemm_tn_rejects_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(18)
    a, b = _t(_bf16_np(rng, 256, 128)), _t(_bf16_np(rng, 256, 64))
    bad = {"rows_differ": (a, b[:192]), "rows": (a[:0], b[:0]), "ka": (a[:, :96], b),
           "nb": (a, b[:, :32]), "dtype": (a.float(), b), "rank": (a[None], b)}[case]
    with pytest.raises(ValueError):
        G.gemm_tn(*bad)


@pytest.mark.parametrize("case", ["shape", "width", "too_wide", "dh_dtype", "x_dtype", "ln_w"])
def test_ln_backward_rejects_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(19)
    x, g = _t(_bf16_np(rng, 64, 384)), _t(_bf16_np(rng, 64, 384))
    dh, w = torch.zeros(64, 384), _t(_bf16_np(rng, 384, offset=1.0))
    wide = torch.zeros(64, 1032, dtype=BF16)
    bad = {"shape": (x, dh[:32], g, w), "width": (x[:, :380], dh[:, :380], g[:, :380], w[:380]),
           "too_wide": (wide, wide.float(), wide, torch.ones(1032, dtype=BF16)),
           "dh_dtype": (x, dh.to(BF16), g, w), "x_dtype": (x.float(), dh, g, w),
           "ln_w": (x, dh, g, w[:128])}[case]
    with pytest.raises(ValueError):
        G.ln_backward(*bad)


@pytest.mark.parametrize("entry", ["gemm_nn", "gemm_tn", "ln_backward"])
def test_entries_refuse_a_device_without_a_kernel(entry):
    """A tensor neither on the CPU nor on a CUDA device has no kernel and no
    plain fallback: ValueError."""
    meta = lambda *s, dtype=BF16: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        if entry == "gemm_nn":
            G.gemm_nn(meta(128, 64), meta(64, 128), "bf16")
        elif entry == "gemm_tn":
            G.gemm_tn(meta(128, 64), meta(128, 64))
        else:
            G.ln_backward(meta(64, 128), meta(64, 128, dtype=torch.float32), meta(64, 128),
                          meta(128))


def test_gemm_sweep_finds_what_it_patches_and_every_form():
    """``tools/gemm_sweep.py`` patches ``plan_for``'s plan line in
    ``csrc/vit_block.cuh`` (it refuses to run when the line is gone) and
    sweeps every backward form of ``chip_smoke.py`` phase 3; its TN row
    splits are multiples of 64 rows that cover the contracted rows."""
    import os

    import chip_smoke as cs
    from sod_tpu_torch.tools import gemm_sweep

    with open(os.path.join(os.path.dirname(G.__file__), "..", "csrc", "vit_block.cuh")) as f:
        assert gemm_sweep.PLAN_LINE in f.read()
    names = [s[0] for s in gemm_sweep.shapes() if s[1] != "nt"]
    assert names == [f[0] for f in cs.GEMM_BWD_FORMS]
    splits = [sp for c, t, sp in gemm_sweep.candidates("tn", 384, 7168, G.CONFIGS) if c == 3]
    assert all(sp % 64 == 0 and -(-7168 // sp) <= max(gemm_sweep.TN_SPLITS) for sp in splits)
    assert all(not G.CONFIGS[c].startswith("panel")
               for c, _, _ in gemm_sweep.candidates("tn", 384, 7168, G.CONFIGS))


def test_phase_3_backward_bounds():
    """The backward forms' bounds as host functions: each moves more bytes
    than its products take at 989 TFLOP/s except where it recomputes the
    hidden (then both about 15 us); K3's dWproj moves g and attn (11.0 MB)
    and writes 0.59 MB of f32: 3.46 us at 3.35 TB/s."""
    import chip_smoke as cs

    b = cs.gemm_bwd_bound("tn", 7168, 384, 384, None)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - (2 * 7168 * 768 + 4 * 384 * 384) / 3.35e12 * 1e3) <= 1e-12
    rc, kept = (cs.gemm_bwd_bound("nn", 6336, 1536, 384, e) for e in ("dgelu", "dgelu_kept"))
    assert 0.0150 <= rc["bound_ms"] <= 0.0155 and kept["bound_ms"] > rc["bound_ms"]
    assert cs.gemm_bwd_bound("nn", 7168, 384, 1152, "f32")["bound_by"] == "bytes"
    assert cs.ln_bwd_bound(7168, 384)["bound_by"] == "bytes"
    assert [f[1] for f in cs.GEMM_BWD_FORMS].count("tn") == 4
    assert {rows for _, _, rows, *_ in cs.GEMM_BWD_FORMS} == {7168, 6336}
