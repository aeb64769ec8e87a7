"""The canvas-evaluation kernels of the port against ``sod_tpu``'s Pallas
kernels in interpret mode, on the CPU (where each wrapper runs its plain
version; ``chip_smoke.py`` holds the CUDA kernels against the same plain
versions on the card).

* K6 ``fmax_tp_cnt``: counts exactly equal to ``_tp_cnt_pallas`` and to the
  XLA twin, with rectangles smaller than the canvas and values sitting on
  the thresholds.
* K7 ``ub_inter_cnt``: counts exactly equal to ``_ub_pallas`` at upsample
  factors 8, 4 and 2 (``scale_factor`` 1, 2, 4); the inputs hold no
  upsampled value within 1e-6 of 0.5, where a different product order
  could flip a count.  A numpy emulation of the CUDA kernel's scheme (bands
  of canvas rows, the W pass once per low row a band touches, 32-column
  ballots of bits, popcounts) gives the same counts, and the band plan
  covers every tap of every row at canvas sides 150-400 and each upsample
  ratio the plain version takes.
* K5 ``fused_ln_attn_infer`` and the K4 forward ``fused_ln_mlp``: bf16
  outputs within one bf16 ulp at their magnitude of ``_fwd_pallas_large``
  and ``_rows_pallas`` (K1's test standard: 1e-2 absolute plus 2^-7
  relative), K5 at n > 1024 with and without a key mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.ops import fsweep as jax_fsweep
from sod_tpu.ops.fused_attn import _fwd_pallas_large
from sod_tpu.ops.fused_mlp import _rows_pallas
from sod_tpu.ops.fused_ub import _ub_pallas
from sod_tpu.ops.resize import _resize_matrix as jax_resize_matrix
from sod_tpu_torch.models.vit import Block, ViTConfig
from sod_tpu_torch.ops import fsweep, fused_attn, fused_mlp, fused_ub
from sod_tpu_torch.ops.resize import _resize_matrix

ATOL, RTOL = 1e-2, 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- K6

def _sweep_case(seed, b=3, m=2, h=40, w=24):
    r = np.random.RandomState(seed)
    masks = r.rand(b, m, h, w).astype(np.float32)
    # a quarter of the pixels exactly on a threshold of the compiled table,
    # some on t / 255 as written (the other table), a few at 0 and 1
    table = fsweep.threshold_table(255, "cpu").numpy()
    on = r.rand(b, m, h, w) < 0.25
    masks[on] = table[r.randint(0, 255, on.sum())]
    written = np.arange(255, dtype=np.float32) / np.float32(255)
    on2 = r.rand(b, m, h, w) < 0.1
    masks[on2] = written[r.randint(0, 255, on2.sum())]
    masks[:, :, 0, :3] = (0.0, 1.0, 1.0 - 1e-7)
    gt = (r.rand(b, h, w) > 0.5).astype(np.float32)
    sizes = np.array([[h, w], [h // 2, w - 5], [7, 3]])[:b]
    rowv = np.arange(h)[None] < sizes[:, :1]
    colv = np.arange(w)[None] < sizes[:, 1:]
    return masks, gt, rowv, colv


def test_threshold_table_is_sod_tpu_compiled_table():
    """``arange(255) / 255`` as XLA compiles it (a product with 1/255)."""
    jitted = np.asarray(jax.jit(lambda: jnp.arange(255, dtype=jnp.float32) / 255)())
    assert np.array_equal(fsweep.threshold_table(255, "cpu").numpy(), jitted)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_equals_pallas_interpret_and_xla_twin(seed):
    masks, gt, rowv, colv = _sweep_case(seed)
    got_tp, got_cnt = fsweep.fmax_tp_cnt_reference(_t(masks), _t(gt), _t(rowv),
                                                   _t(colv))
    args = tuple(jnp.asarray(a) for a in (masks, gt, rowv, colv))
    ref_k = jax_fsweep._tp_cnt_pallas(*args, 255, interpret=True)
    ref_x = jax.jit(jax_fsweep.fmax_tp_cnt)(*args)
    for ref in (ref_k, ref_x):
        np.testing.assert_array_equal(got_tp.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(ref[1]))
    assert got_cnt[1].max() <= rowv[1].sum() * colv[1].sum()


def test_sweep_wrapper_runs_plain_version_on_cpu():
    masks, gt, rowv, colv = (_t(a) for a in _sweep_case(2))
    before = fsweep.launches
    got = fsweep.fmax_tp_cnt(masks, gt, rowv, colv)
    ref = fsweep.fmax_tp_cnt_reference(masks, gt, rowv, colv)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fsweep.launches == before
    with pytest.raises(ValueError):
        fsweep.fmax_tp_cnt(masks, gt[:, :-1], rowv, colv)


@pytest.mark.parametrize("w", [21, 37])
def test_sweep_wrapper_takes_bool_or_uint8_at_any_width(w):
    """rowv / colv as bool or uint8 (the kernel reads either byte as it is)
    and a width that is not a multiple of 4 (the kernel's scalar path): the
    wrapper's plain version equals the interpret-mode Pallas kernel."""
    masks, gt, rowv, colv = _sweep_case(3, w=w)
    ref = jax_fsweep._tp_cnt_pallas(*(jnp.asarray(a) for a in (masks, gt, rowv, colv)), 255,
                                    interpret=True)
    for dt in (torch.bool, torch.uint8):
        got = fsweep.fmax_tp_cnt(_t(masks), _t(gt), _t(rowv).to(dt), _t(colv).to(dt))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sweep_band_plan_and_kernel_layout():
    """The kernel's band plan (host arithmetic): the eval shape's 16 bands of
    25 rows, 256 blocks, one wave of two per SM; every plan within 256 rows
    and the 16-bit count of a histogram copy (two warps).  The layout the
    kernel reads is checked before a launch."""
    assert fsweep.band_rows(16, 400, 400) == 25 and fsweep.band_rows(1, 224, 224) == 16
    for b, h, w in ((16, 400, 400), (4, 400, 400), (1, 224, 224), (2, 33, 7), (1, 3000, 3000),
                    (3, 5000, 20000), (300, 64, 64)):
        rows = fsweep.band_rows(b, h, w)
        bands = -(-h // rows)
        assert 1 <= rows <= 256 and rows * (w + 3) <= 8 * 65000
        if w < 8000 and h < 8000:
            assert b * bands <= 2 * 132 or bands == max(1, -(-h // 256)), (b, h, w)
    masks, gt, rowv, colv = (_t(a) for a in _sweep_case(4))
    fsweep._check_layout(masks, gt, rowv, colv.to(torch.uint8))
    for bad in ((masks.double(), gt, rowv, colv), (masks, gt, rowv.int(), colv),
                (masks.transpose(2, 3), gt, rowv, colv),
                (torch.cat([masks] * 3, 1), gt, rowv, colv)):
        with pytest.raises(ValueError):
            fsweep._check_layout(*bad)


def test_fsweep_ab_variants_cut_the_current_source():
    """``tools/fsweep_ab.py`` cuts parts out of a copy of ``csrc/fsweep.cu``
    by text: each cut still finds its text, and each variant differs."""
    import os

    from sod_tpu_torch.ops import _build
    from sod_tpu_torch.tools import fsweep_ab

    with open(os.path.join(_build.CSRC_DIR, "fsweep.cu")) as f:
        src = f.read()
    v = fsweep_ab._variant_sources(src)
    assert v["whole"] == src and len(set(v.values())) == 6
    assert "atomicAdd(&wh[" not in v["loads"] and "if (!last) return;" not in v["no_finish"]


# --------------------------------------------------------------- K7

def _ub_case(seed, up, b=3, q=5, h0=9, w0=7):
    """Low-res masks away from the 0.5 crossing after the upsample."""
    r = np.random.RandomState(seed)
    low = r.rand(b, q, h0, w0).astype(np.float32)
    hh, ww = h0 * up, w0 * up
    wh, wwt = _resize_matrix(h0, hh, "bilinear"), _resize_matrix(w0, ww, "bilinear").T
    gt = (r.rand(b, hh, ww) > 0.6).astype(np.float32)
    sizes = np.array([[hh, ww], [hh - up - 1, ww // 2], [up + 2, ww - 3]])[:b]
    rowv = np.arange(hh)[None] < sizes[:, :1]
    colv = np.arange(ww)[None] < sizes[:, 1:]
    return low, gt, rowv, colv, wh, wwt


@pytest.mark.parametrize("scale_factor", [1, 2, 4])
def test_ub_plain_equals_pallas_interpret(scale_factor):
    up = 8 // scale_factor
    low, gt, rowv, colv, wh, wwt = _ub_case(scale_factor, up)
    upsampled = np.einsum("Hh,bqhw,wW->bqHW", wh.astype(np.float64), low, wwt)
    assert np.abs(upsampled - 0.5).min() > 1e-6
    assert np.array_equal(wh, jax_resize_matrix(low.shape[2], gt.shape[1], "bilinear"))
    got = fused_ub.ub_inter_cnt_reference(_t(low), _t(gt), _t(rowv), _t(colv))
    ref = _ub_pallas(*(jnp.asarray(a) for a in (low, gt, rowv, colv)), wh, wwt,
                     interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _kernel_arithmetic(low, gt, rowv, colv, wh, wwt):
    """The CUDA kernel's arithmetic in numpy f32: two taps per output row
    and column from ``taps``, products and sums rounded once each."""
    (ri, rw), (ci, cw) = fused_ub.taps(wh), fused_ub.taps(wwt.T)
    f = np.float32
    y0 = low[..., ri[:, 0], :][..., ci[:, 0]] * cw[:, 0] + low[..., ri[:, 0], :][..., ci[:, 1]] * cw[:, 1]
    y1 = low[..., ri[:, 1], :][..., ci[:, 0]] * cw[:, 0] + low[..., ri[:, 1], :][..., ci[:, 1]] * cw[:, 1]
    up = f(rw[:, 0, None]) * y0 + f(rw[:, 1, None]) * y1
    valid = rowv[:, None, :, None] & colv[:, None, None, :]
    pb = (up > 0.5) & valid
    return ((pb & (gt[:, None] > 0)).sum((2, 3)).astype(f), pb.sum((2, 3)).astype(f))


@pytest.mark.parametrize("scale_factor", [1, 2, 4])
def test_ub_taps_rebuild_the_matrices_and_the_counts(scale_factor):
    """``taps`` (what the kernel reads) holds every nonzero of the bilinear
    matrices, edge rows with their merged weight, and the kernel's tap
    arithmetic gives the plain version's counts."""
    up = 8 // scale_factor
    low, gt, rowv, colv, wh, wwt = _ub_case(10 + scale_factor, up)
    for mat in (wh, wwt.T):
        idx, w = fused_ub.taps(mat)
        dense = np.zeros_like(mat)
        np.add.at(dense, (np.arange(len(mat))[:, None], idx), w)
        assert np.array_equal(dense, mat)
    got = _kernel_arithmetic(low, gt, rowv, colv, wh, wwt)
    ref = fused_ub.ub_inter_cnt_reference(_t(low), _t(gt), _t(rowv), _t(colv))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    # the device tables the kernel reads: the same taps, made once per shape
    h0, w0 = low.shape[2:]
    dev = fused_ub._device_taps(h0, gt.shape[1], w0, gt.shape[2], torch.device("cpu"))
    assert dev is fused_ub._device_taps(h0, gt.shape[1], w0, gt.shape[2], torch.device("cpu"))
    for a, b in zip(dev, (*fused_ub.taps(wh), *fused_ub.taps(wwt.T))):
        np.testing.assert_array_equal(a.numpy(), b)


def test_ub_wrapper_runs_plain_version_on_cpu():
    low, gt, rowv, colv, _, _ = _ub_case(3, 4)
    before = fused_ub.launches
    args = (_t(low), _t(gt), _t(rowv), _t(colv))
    got = fused_ub.ub_inter_cnt(*args)
    ref = fused_ub.ub_inter_cnt_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fused_ub.launches == before
    with pytest.raises(ValueError):
        fused_ub.ub_inter_cnt(args[0], args[1][:, :-1], *args[2:])
    with pytest.raises(ValueError):
        fused_ub.taps(np.ones((4, 3), np.float32))       # 3 taps: not bilinear


def _bits(mask):
    """Rows of booleans [R, W] as the kernel's 32-column ballot words."""
    pad = -mask.shape[1] % 32
    m = np.pad(mask, ((0, 0), (0, pad)))
    return np.packbits(m, axis=1, bitorder="little").view("<u4")


def _popcount(words):
    return int(np.unpackbits(words.view(np.uint8)).sum())


def _band_emulation(low, gt, rowv, colv):
    """The CUDA kernel's scheme in numpy f32: per (image, band of canvas
    rows) the valid and GT bits, then per query the W pass over the band's
    low rows and the H pass, ballots and popcounts."""
    b, q, h0, w0 = low.shape
    hh, ww = gt.shape[1:]
    r_idx, r_w, c_idx, c_w, plan = fused_ub._host_taps(h0, hh, w0, ww)
    rows = fused_ub.BAND_ROWS
    inter, cnt = np.zeros((b, q), np.int64), np.zeros((b, q), np.int64)
    for bi in range(b):
        for band, (lo, n_lr) in enumerate(plan):
            rr = np.arange(band * rows, min((band + 1) * rows, hh))
            valid = rowv[bi, rr][:, None] & colv[bi][None, :]
            vbits, gbits = _bits(valid), _bits(valid & (gt[bi, rr] > 0))
            t = r_idx[rr] - lo
            assert t.min() >= 0 and t.max() < n_lr
            for qi in range(q):
                lows = low[bi, qi, lo:lo + n_lr]
                y = lows[:, c_idx[:, 0]] * c_w[:, 0] + lows[:, c_idx[:, 1]] * c_w[:, 1]
                up = r_w[rr, :1] * y[t[:, 0]] + r_w[rr, 1:] * y[t[:, 1]]
                pred = _bits(up > 0.5) & vbits
                inter[bi, qi] += _popcount(pred & gbits)
                cnt[bi, qi] += _popcount(pred)
    return inter.astype(np.float32), cnt.astype(np.float32)


@pytest.mark.parametrize("scale_factor", [1, 2, 4])
def test_ub_band_scheme_equals_plain_and_pallas(scale_factor):
    up = 8 // scale_factor
    low, gt, rowv, colv, wh, wwt = _ub_case(20 + scale_factor, up)
    got = _band_emulation(low, gt, rowv, colv)
    ref = fused_ub.ub_inter_cnt_reference(_t(low), _t(gt), _t(rowv), _t(colv))
    pallas = _ub_pallas(*(jnp.asarray(a) for a in (low, gt, rowv, colv)), wh, wwt,
                        interpret=True)
    for g, r, p in zip(got, ref, pallas):
        assert g.max() > 0
        np.testing.assert_array_equal(g, r.numpy())
        np.testing.assert_array_equal(g, np.asarray(p))


@pytest.mark.parametrize("ratio", [8, 4, 2, 3, 1])
def test_ub_band_plan_covers_every_tap(ratio):
    """Every canvas row's two taps lie in its band's low rows, a weight-0
    tap sits on its row's real tap, and at an integer ratio a band reads at
    most BAND_ROWS / ratio + 2 low rows, so a block's shared memory holds
    20 queries' counts at every canvas side from 150 to 400."""
    rows = fused_ub.BAND_ROWS
    for side in range(150, 401, 2):
        h0 = -(-side // ratio)
        idx, w = fused_ub.taps(_resize_matrix(h0, side, "bilinear"))
        assert np.all((w[:, 1] != 0) | (idx[:, 1] == idx[:, 0]))
        plan = fused_ub.band_plan(idx)
        assert len(plan) == -(-side // rows)
        for band, (lo, n) in enumerate(plan):
            t = idx[band * rows:(band + 1) * rows]
            assert lo == t.min() and lo + n - 1 == t.max() and 0 <= lo and lo + n <= h0
            assert n <= -(-rows // ratio) + 2
        assert fused_ub.smem_bytes(rows, side, int(plan[:, 1].max()), 20, h0) <= fused_ub.MAX_SMEM


# --------------------------------------------------------------- K5, K4

D, HEADS, HIDDEN = 64, 2, 256


def _jax_block(seed):
    r = np.random.RandomState(seed)
    t = lambda *s, sc=0.05: (r.randn(*s) * sc).astype(np.float32)  # noqa: E731
    return {"norm1": {"scale": 1 + t(D, sc=0.1), "bias": t(D, sc=0.1)},
            "attn": {"qkv": {"w": t(D, 3 * D), "b": t(3 * D)},
                     "proj": {"w": t(D, D), "b": t(D)}},
            "norm2": {"scale": 1 + t(D, sc=0.1), "bias": t(D, sc=0.1)},
            "mlp": {"fc0": {"w": t(D, HIDDEN), "b": t(HIDDEN)},
                    "fc1": {"w": t(HIDDEN, D), "b": t(D)}}}


def _port_block(bp):
    blk = Block(ViTConfig(embed_dim=D, n_heads=HEADS, depth=1, pos_grid=4))
    lin = lambda p, n: {f"{n}.weight": _t(p["w"].T), f"{n}.bias": _t(p["b"])}  # noqa: E731
    ln = lambda p, n: {f"{n}.weight": _t(p["scale"]), f"{n}.bias": _t(p["bias"])}  # noqa: E731
    blk.load_state_dict({**ln(bp["norm1"], "norm1"), **ln(bp["norm2"], "norm2"),
                         **lin(bp["attn"]["qkv"], "attn.qkv"),
                         **lin(bp["attn"]["proj"], "attn.proj"),
                         **lin(bp["mlp"]["fc0"], "mlp.fc1"),
                         **lin(bp["mlp"]["fc1"], "mlp.fc2")})
    return blk.to(torch.bfloat16)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_attn_infer_plain_matches_pallas_interpret(masked):
    """K5 at 1536 padded tokens (three of ``_large_chunk``'s 512-row
    chunks), 1100 of them real; with a canvas-style key mask."""
    bp = _jax_block(0)
    n_pad, n_real = 1536, 1100
    r = np.random.RandomState(1)
    x = jnp.asarray(r.randn(2, n_pad, D).astype(np.float32)).astype(jnp.bfloat16)
    km = None
    if masked:
        km = np.zeros((2, n_pad), bool)
        km[0, :700], km[1, :1100] = True, True
    weights = tuple(jnp.asarray(a).reshape(1, -1) if a.ndim == 1 else jnp.asarray(a)
                    for a in (bp["norm1"]["scale"], bp["norm1"]["bias"],
                              bp["attn"]["qkv"]["w"], bp["attn"]["qkv"]["b"],
                              bp["attn"]["proj"]["w"], bp["attn"]["proj"]["b"]))
    ref = _fwd_pallas_large(x, weights, HEADS, n_real, 1e-6, (D // HEADS) ** -0.5,
                            key_mask=None if km is None else jnp.asarray(km),
                            interpret=True)
    xt = _t(_bf16_np(x)).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_attn.fused_ln_attn_infer_reference(
            xt, _port_block(bp), HEADS, n_real,
            key_mask=None if km is None else _t(km))
    assert got.dtype == torch.bfloat16
    got, ref = got.float().numpy()[:, :n_real], _bf16_np(ref)[:, :n_real]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


def test_mlp_forward_plain_matches_pallas_interpret():
    bp = _jax_block(2)
    r = np.random.RandomState(3)
    x = jnp.asarray(r.randn(200, D).astype(np.float32) * 2).astype(jnp.bfloat16)
    weights = (jnp.asarray(bp["norm2"]["scale"]).reshape(1, -1).astype(jnp.bfloat16),
               jnp.asarray(bp["norm2"]["bias"]).reshape(1, -1).astype(jnp.bfloat16),
               jnp.asarray(bp["mlp"]["fc0"]["w"]).astype(jnp.bfloat16),
               jnp.asarray(bp["mlp"]["fc0"]["b"]).reshape(1, -1).astype(jnp.bfloat16),
               jnp.asarray(bp["mlp"]["fc1"]["w"]).astype(jnp.bfloat16),
               jnp.asarray(bp["mlp"]["fc1"]["b"]).reshape(1, -1).astype(jnp.bfloat16))
    ref = _bf16_np(_rows_pallas(x, weights, 1e-6, interpret=True, chunk=64))
    with torch.no_grad():
        got = fused_mlp.fused_ln_mlp_reference(_t(_bf16_np(x)).to(torch.bfloat16),
                                               _port_block(bp))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL, rtol=RTOL)


def test_attn_and_mlp_wrappers_run_plain_versions_on_cpu():
    blk = _port_block(_jax_block(4))
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 256, D).astype(np.float32)
                         ).to(torch.bfloat16)
    km = torch.ones(2, 256, dtype=torch.bool)
    km[1, 100:] = False
    before = (fused_attn.launches, fused_mlp.launches)
    with torch.no_grad():
        assert torch.equal(fused_attn.fused_ln_attn_infer(x, blk, HEADS, 200, km),
                           fused_attn.fused_ln_attn_infer_reference(x, blk, HEADS, 200, km))
        # rows that are not a multiple of the kernel's 64-row tile
        x3 = x[:, :70]
        assert torch.equal(fused_mlp.fused_ln_mlp(x3, blk),
                           fused_mlp.fused_ln_mlp_reference(x3, blk))
    assert (fused_attn.launches, fused_mlp.launches) == before


@pytest.mark.parametrize("case", ["n_pad_not_128", "float32", "key_mask_shape",
                                  "head_dim", "n_real"])
def test_attn_wrapper_rejects_what_the_kernel_does_not_take(case):
    blk = _port_block(_jax_block(6))
    x = torch.zeros(1, 256, D, dtype=torch.bfloat16)
    kw, n_heads, n_real = {}, HEADS, 200
    if case == "n_pad_not_128":
        x = torch.zeros(1, 250, D, dtype=torch.bfloat16)
    elif case == "float32":
        x = x.float()
    elif case == "key_mask_shape":
        kw["key_mask"] = torch.ones(1, 255, dtype=torch.bool)
    elif case == "head_dim":
        n_heads = 4                          # head dim 16: no kernel built for it
    else:
        n_real = 257
    with pytest.raises(ValueError):
        fused_attn.fused_ln_attn_infer(x, blk, n_heads, n_real, **kw)
