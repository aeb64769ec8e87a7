"""The port's canvas evaluation against ``sod_tpu``'s, on the CPU, at a
small size (ViT d 64, 2 heads, depth 2; 2 decoder layers; 4 queries) with
the same weights (``maskformer_init`` carried over by
``state_dict_from_jax``) and the same numpy inputs.

* Metrics: ``rect_metrics``, ``eval_batch_metrics`` and
  ``eval_batch_metrics_lowres`` (every ``cost_type``) on identical f32
  inputs: chosen indices and count-derived metrics equal, continuous ones
  (mae, f_mean, s_measure) within 1e-6.
* The canvas forward in f32: ``pos_embed_canvas_device`` and
  ``maskformer_apply_canvas`` within 1e-4 (ROADMAP's fp32 standard), with
  three image sizes on one canvas, one of them the table's native grid.
* The bf16 fused encoder on the canvas, on both sides of n_pad = 1024:
  K1 masked, against ``sod_tpu``'s K1 in interpret mode; above it K5 then
  K4 per block, against ``_fwd_pallas_large`` and ``_rows_pallas`` in
  interpret mode composed the same way (off a TPU ``sod_tpu`` itself runs
  the unfused blocks there).  One bf16 ulp: 1e-2 + 2^-7 relative.
* The Evaluator end to end (f32, default and ``use_fused_eval``) on a
  synthetic DUTS-TE of four images of different sizes: metric dicts within
  1e-4 of ``sod_tpu``'s Evaluator, identical keys, byte-equal CSV header,
  the same errors for a bad ``scale_factor`` or ``cost_type``.
* The Trainer's evaluation, the evaluate CLI, and imports without jax.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import sod_tpu.ops.fused_block as jax_fused_block
from sod_tpu.config import Config
from sod_tpu.metrics import batched as jax_batched
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_apply_canvas as jax_apply_canvas
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.models.vit import pos_embed_canvas_device as jax_pos_embed_canvas
from sod_tpu.models.vit import prepare_tokens as jax_prepare_tokens
from sod_tpu.models.vit import vit_apply as jax_vit_apply
from sod_tpu.ops.layers import layer_norm as jax_layer_norm
from sod_tpu.ops.resize import interpolate_bilinear as jax_bilinear
from sod_tpu.train.evaluator import Evaluator as JaxEvaluator
from sod_tpu_torch.cli import evaluate as cli
from sod_tpu_torch.metrics import batched
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, maskformer_apply_canvas
from sod_tpu_torch.models.vit import ViTConfig, pos_embed_canvas_device, vit_apply
from sod_tpu_torch.ops.fsweep import fmax_tp_cnt
from sod_tpu_torch.ops.resize import bilinear_separable
from sod_tpu_torch.train.evaluator import CSV_HEADER, Evaluator
from sod_tpu_torch.train.trainer import Trainer

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
JCFG = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT))
TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTED = ("iou", "pixel_acc", "f_measure", "f_max")
CONTINUOUS = ("mae", "f_mean", "s_measure")


@pytest.fixture(scope="module")
def weights():
    params = maskformer_init(jax.random.key(0), JCFG)
    model = MaskFormer(TCFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(jax.tree.map(np.asarray, params)).items()})
    return params, model.eval()


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _assert_metrics(got, ref, keys):
    for k in keys:
        g, r = _np(got[k]), _np(ref[k])
        if k.endswith("_index") or k.split("_ub")[0] in COUNTED:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)


# --------------------------------------------------------------- metrics

def _metric_case(seed, b=3, q=5, h0=11, w0=9, up=4):
    """Low-res masks whose x4 upsample keeps clear of 0.5, the GT box and
    valid rectangles smaller than the canvas."""
    r = np.random.RandomState(seed)
    low = r.rand(b, q, h0, w0).astype(np.float32)
    hh, ww = h0 * up, w0 * up
    gt = np.zeros((b, hh, ww), np.float32)
    for i in range(b):
        gt[i, 5 + i:25, 4:20 + 3 * i] = 1.0
    sizes = np.array([[hh, ww], [hh - 7, ww - 11], [30, 21]], np.int32)[:b]
    obj = r.rand(b, q).astype(np.float32)
    up_np = np.array(jax_bilinear(jnp.asarray(low), hh, ww))
    assert np.abs(up_np - 0.5).min() > 1e-6
    return low, up_np, obj, gt, sizes


def test_rect_metrics_match_sod_tpu():
    _, up, _, gt, sizes = _metric_case(0)
    pred = up[:, 0]
    t = torch.from_numpy
    rowv, colv = batched._sweep_inputs(t(sizes), *gt.shape[-2:], "cpu")
    tp, cnt = fmax_tp_cnt(t(pred)[:, None], t(gt), rowv, colv)
    got = batched.rect_metrics(t(pred), t(gt), t(sizes[:, 0]), t(sizes[:, 1]),
                               (tp[:, 0], cnt[:, 0]))
    ref = jax.jit(jax.vmap(jax_batched.rect_metrics))(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(sizes[:, 0]),
        jnp.asarray(sizes[:, 1]))
    _assert_metrics(got, ref, COUNTED + CONTINUOUS)


@pytest.mark.parametrize("cost_type", ["iou", "f_measure", "f_max", "mae"])
def test_batch_metrics_match_sod_tpu(cost_type):
    low, up, obj, gt, sizes = _metric_case(1)
    t = torch.from_numpy
    j = jnp.asarray
    keys = [*COUNTED, *CONTINUOUS, *(f"{k}_ub" for k in COUNTED + CONTINUOUS),
            "selected_index", "ub_index"]
    got = batched.eval_batch_metrics(t(up), t(obj), t(gt), t(sizes), cost_type)
    ref = jax.jit(functools.partial(jax_batched.eval_batch_metrics,
                                    cost_type=cost_type))(j(up), j(obj), j(gt), j(sizes))
    _assert_metrics(got, ref, keys)
    got_lo = batched.eval_batch_metrics_lowres(t(low), t(obj), t(gt), t(sizes), cost_type)
    ref_lo = jax.jit(functools.partial(jax_batched.eval_batch_metrics_lowres,
                                       cost_type=cost_type))(j(low), j(obj), j(gt), j(sizes))
    _assert_metrics(got_lo, ref_lo, keys)
    # the low-res path chooses what the materialising one does
    assert torch.equal(got_lo["ub_index"], got["ub_index"])


def test_bilinear_separable_is_sod_tpus_contraction():
    low, up, *_ = _metric_case(2)
    got = bilinear_separable(torch.from_numpy(low), up.shape[-2], up.shape[-1])
    np.testing.assert_allclose(got.numpy(), up, rtol=0, atol=2e-7)


def test_single_image_metrics_match_sod_tpu():
    from sod_tpu import metrics as jm
    from sod_tpu_torch.metrics import f_measure, s_measure, simple

    r = np.random.RandomState(3)
    pred = r.rand(37, 45).astype(np.float32)
    gt = np.zeros((37, 45), np.float32)
    gt[8:25, 10:35] = 1.0
    tp, tg, jp, jg = torch.from_numpy(pred), torch.from_numpy(gt), jnp.asarray(pred), jnp.asarray(gt)
    pairs = [(simple.compute_iou(tp, tg), jm.compute_iou(jp, jg)),
             (simple.compute_mae(tp, tg), jm.compute_mae(jp, jg)),
             (simple.compute_pixel_accuracy(tp, tg), jm.compute_pixel_accuracy(jp, jg)),
             (s_measure.s_measure(tp, tg), jax.jit(jm.s_measure)(jp, jg))]
    f_got, f_ref = f_measure.f_measure_all(tp, tg), jax.jit(jm.f_measure_all)(jp, jg)
    pairs += [(f_got[k], f_ref[k]) for k in f_ref]
    for g, ref in pairs:
        np.testing.assert_allclose(_np(g), _np(ref), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- canvas forward

def _canvas_batch(table, images, p=8):
    """Canvas inputs for a list of [h, w, 3] images."""
    pad = lambda v: -(-v // p) * p  # noqa: E731
    ch, cw = max(pad(im.shape[0]) for im in images), max(pad(im.shape[1]) for im in images)
    gh_c, gw_c = ch // p, cw // p
    x = np.zeros((len(images), ch, cw, 3), np.float32)
    grids = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        x[i, :im.shape[0], :im.shape[1]] = im
        grids[i] = (pad(im.shape[0]) // p, pad(im.shape[1]) // p)
    rows = np.arange(gh_c)[None, :, None] < grids[:, :1, None]
    cols = np.arange(gw_c)[None, None, :] < grids[:, 1:, None]
    tok = np.concatenate([np.ones((len(images), 1), bool),
                          (rows & cols).reshape(len(images), -1)], 1)
    pe = np.asarray(jax.vmap(lambda a, b: jax_pos_embed_canvas(
        jnp.asarray(table), a, b, (gh_c, gw_c)))(jnp.asarray(grids[:, 0]),
                                                  jnp.asarray(grids[:, 1])))
    return x, tok, pe, grids


def _images(rng, sizes):
    return [rng.randn(h, w, 3).astype(np.float32) for h, w in sizes]


def test_pos_embed_canvas_matches_sod_tpu(weights, rng):
    params, model = weights
    table = np.asarray(params["encoder"]["pos_embed"])
    _, _, pe, grids = _canvas_batch(table, _images(rng, [(45, 62), (32, 32), (64, 24)]))
    got = pos_embed_canvas_device(model.encoder.pos_embed.detach(),
                                  torch.from_numpy(grids[:, 0]),
                                  torch.from_numpy(grids[:, 1]), (8, 8))
    np.testing.assert_allclose(got.numpy(), pe, atol=1e-5, rtol=0)
    # the native 4 x 4 grid takes the table as it is
    np.testing.assert_array_equal(got[1, 1:].reshape(8, 8, -1)[:4, :4].reshape(16, -1).numpy(),
                                  table[0, 1:])
    # the host twin: sod_tpu's numpy interpolation, the same array
    from sod_tpu.train.evaluator import host_pos_embed as jax_host_pos_embed
    from sod_tpu_torch.train.evaluator import host_pos_embed

    for gh, gw in ((6, 8), (4, 4), (8, 3)):
        np.testing.assert_array_equal(host_pos_embed(table, gh, gw, 4),
                                      jax_host_pos_embed(table, gh, gw, 4))


@pytest.mark.parametrize("fused", [False, True])
def test_canvas_forward_matches_sod_tpu(weights, rng, fused):
    """f32 (``fused`` asks for the kernels; f32 takes the unfused blocks,
    in both packages)."""
    params, model = weights
    x, tok, pe, grids = _canvas_batch(np.asarray(params["encoder"]["pos_embed"]),
                                      _images(rng, [(45, 62), (32, 32), (64, 24)]))
    ref = jax_apply_canvas(params, jnp.asarray(x), JCFG, jnp.asarray(tok),
                           jnp.asarray(pe), jnp.asarray(grids), fused=fused)
    with torch.no_grad():
        got = maskformer_apply_canvas(model, torch.from_numpy(x), torch.from_numpy(tok),
                                      torch.from_numpy(pe), torch.from_numpy(grids),
                                      fused=fused)
        last = maskformer_apply_canvas(model, torch.from_numpy(x), torch.from_numpy(tok),
                                       torch.from_numpy(pe), torch.from_numpy(grids),
                                       fused=fused, last_layer_only=True)
    for k in ("mask_pred", "objectness", "features"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), atol=1e-4, rtol=0, err_msg=k)
    # the evaluator's form: the heads of the last decoder layer only
    for k in ("mask_pred", "objectness"):
        assert torch.equal(last[k], got[k][:, -1:]), k
    assert torch.equal(last["features"], got["features"])


@pytest.fixture()
def interpret_k1(monkeypatch):
    monkeypatch.setattr(jax_fused_block, "fused_available", lambda: True)
    monkeypatch.setattr(jax_fused_block, "fused_vit_block",
                        functools.partial(jax_fused_block.fused_vit_block, interpret=True))


def _bf16_inputs(weights, rng, sizes):
    params, model = weights
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    x, tok, pe, _ = _canvas_batch(np.asarray(params["encoder"]["pos_embed"]),
                                  _images(rng, sizes))
    m16 = MaskFormer(TCFG)
    m16.load_state_dict(model.state_dict())
    return p16, m16.to(torch.bfloat16), x, tok, pe


def _port_encoder(m16, x, tok, pe):
    with torch.no_grad():
        return vit_apply(m16.encoder, torch.from_numpy(x).to(torch.bfloat16), fused=True,
                         token_mask=torch.from_numpy(tok),
                         pos_embed_override=torch.from_numpy(pe))


def test_bf16_canvas_encoder_k1_route_matches_interpret_kernel(weights, rng, interpret_k1):
    """n_pad <= 1024: masked K1 per block."""
    p16, m16, x, tok, pe = _bf16_inputs(weights, rng, [(45, 62), (32, 32), (64, 24)])
    ref = jax_vit_apply(p16["encoder"], jnp.asarray(x).astype(jnp.bfloat16), JCFG.vit,
                        all_layers=False, token_mask=jnp.asarray(tok),
                        pos_embed_override=jnp.asarray(pe), fused=True)
    got = _port_encoder(m16, x, tok, pe)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-2, rtol=2.0 ** -7)


def test_bf16_canvas_encoder_gridded_route_matches_interpret_kernels(weights, rng):
    """n_pad > 1024 (34 x 33 patches + CLS = 1123 tokens): K5 then K4 per
    block, against the Pallas kernels composed as ``vit_apply``'s gridded
    branch composes them."""
    from sod_tpu.ops import fused_attn as jfa
    from sod_tpu.ops import fused_mlp as jfm

    p16, m16, x, tok, pe = _bf16_inputs(weights, rng, [(272, 264), (200, 150)])
    enc, cfg = p16["encoder"], JCFG.vit
    tokens, _ = jax_prepare_tokens(enc, jnp.asarray(x).astype(jnp.bfloat16), cfg,
                                   jnp.asarray(pe))
    b, n, d = tokens.shape
    n_pad = -(-n // 512) * 512
    xp = jnp.pad(tokens, ((0, 0), (0, n_pad - n), (0, 0)))
    km = jnp.pad(jnp.asarray(tok), ((0, 0), (0, n_pad - n)))
    for i in range(cfg.depth):
        bp = jax.tree.map(lambda a: a[i], enc["blocks"])
        xp = jfa._fwd_pallas_large(xp, jfa._prep_weights(bp["attn"], bp["norm1"]),
                                   cfg.n_heads, n, cfg.ln_eps, (d // cfg.n_heads) ** -0.5,
                                   key_mask=km, interpret=True)
        xp = jfm._rows_pallas(xp.reshape(-1, d), jfm._prep_weights(bp["mlp"], bp["norm2"]),
                              cfg.ln_eps, interpret=True, chunk=512).reshape(b, n_pad, d)
    ref = jax_layer_norm(enc["norm"], xp[:, :n], cfg.ln_eps)
    got = _port_encoder(m16, x, tok, pe)
    assert n > 1024 and got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-2, rtol=2.0 ** -7)


# --------------------------------------------------------------- Evaluator

SIZES = [(40, 48), (32, 32), (56, 24), (45, 37)]


def _write_duts_te(root, rng):
    te, gtd = root / "DUTS" / "DUTS-TE-Image", root / "DUTS" / "DUTS-TE-Mask"
    te.mkdir(parents=True)
    gtd.mkdir(parents=True)
    for i, (h, w) in enumerate(SIZES):
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        img[h // 4:3 * h // 4, w // 5:4 * w // 5] += 150
        Image.fromarray(img).save(te / f"te_{i}.jpg")
        gt = np.zeros((h, w), np.uint8)
        gt[h // 4:3 * h // 4, w // 5:4 * w // 5] = 255
        Image.fromarray(gt).save(gtd / f"te_{i}.png")


@pytest.fixture()
def duts_te(tmp_path, rng):
    _write_duts_te(tmp_path, rng)
    return tmp_path


def _cfg(root, **kw):
    return Config(dir_dataset=str(root), compute_dtype="float32", num_workers=2, **kw)


@pytest.mark.parametrize("fused_eval", [False, True])
def test_evaluator_matches_sod_tpu(weights, duts_te, fused_eval):
    params, model = weights
    cfg = _cfg(duts_te, use_fused_eval=fused_eval)
    ref = JaxEvaluator(params, cfg, JCFG, batch_size=3)(
        "duts", dir_ckpt=str(duts_te / "ref"))
    got = Evaluator(model, cfg, TCFG, batch_size=3, device="cpu")(
        "duts", dir_ckpt=str(duts_te / "got"))
    assert list(got) == list(ref) and "pixel_accuarcy" in got
    for k in ref:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], float(ref[k]), atol=1e-4, rtol=0, err_msg=k)
    with open(duts_te / "got" / "metrics_duts.txt", "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with open(duts_te / "ref" / "metrics_duts.txt", "rb") as f:
        assert lines[0] == f.readline() == CSV_HEADER.encode()
    assert len(lines) == 1 + len(SIZES)


def test_evaluator_with_fused_mlp_matches_sod_tpu(weights, duts_te):
    """The middle eval path (``sod_tpu/train/evaluator.py:239-245``):
    ``use_fused_mlp`` runs every block's MLP half through K4's forward
    (tanh-GELU, matmul inputs rounded to bf16 in an f32 run too) under the
    canvas token mask, with flash attention beside it; both sides run K4's
    plain twin on the CPU."""
    params, model = weights
    jcfg = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2,
                               vit=JaxViTConfig(**VIT, fused_mlp=True))
    tcfg = MaskFormerConfig(n_queries=4, n_decoder_layers=2,
                            vit=ViTConfig(**VIT, fused_mlp=True))
    fused = MaskFormer(tcfg)
    fused.load_state_dict(model.state_dict())
    assert all(blk.fused_mlp for blk in fused.encoder.blocks)
    cfg = _cfg(duts_te, use_fused_mlp=True)
    ref = JaxEvaluator(params, cfg, jcfg, batch_size=3)(
        "duts", dir_ckpt=str(duts_te / "ref"))
    got = Evaluator(fused.eval(), cfg, tcfg, batch_size=3, device="cpu")(
        "duts", dir_ckpt=str(duts_te / "got"))
    plain = Evaluator(model, _cfg(duts_te), TCFG, batch_size=3, device="cpu")(
        "duts", dir_ckpt=str(duts_te / "plain"))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), atol=1e-4, rtol=0, err_msg=k)
    assert any(got[k] != plain[k] for k in got)      # K4's path was taken


@pytest.mark.parametrize("kwargs", [{"scale_factor": 3}, {"scale_factor": 0},
                                    {"cost_type": "dice"}])
def test_evaluator_refuses_what_sod_tpu_refuses(weights, duts_te, kwargs):
    params, model = weights
    cfg = _cfg(duts_te)
    with pytest.raises(ValueError) as ref:
        JaxEvaluator(params, cfg, JCFG, batch_size=4)("duts", **kwargs)
    with pytest.raises(ValueError) as got:
        Evaluator(model, cfg, TCFG, batch_size=4, device="cpu")("duts", **kwargs)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("layout", ["DUTS-OMRON", "DUT-OMRON", "both"])
def test_dut_omron_takes_the_reference_path_first(tmp_path, layout):
    """``sod_tpu``'s factory quirk: ``DUTS-OMRON`` (sic) first, the
    official ``DUT-OMRON`` layout as the fallback; the same files chosen."""
    from sod_tpu.data.factory import get_dataset as jax_get_dataset
    from sod_tpu_torch.data.factory import get_dataset

    for i, root in enumerate(["DUTS-OMRON", "DUT-OMRON"] if layout == "both" else [layout]):
        for sub, ext in (("DUT-OMRON-image", "jpg"), ("pixelwiseGT-new-PNG", "png")):
            (tmp_path / root / sub).mkdir(parents=True)
            for j in range(i + 1):
                (tmp_path / root / sub / f"im{j}.{ext}").write_bytes(b"")
    got = get_dataset(str(tmp_path), "dut_omron", "test")
    ref = jax_get_dataset(str(tmp_path), "dut_omron", "test")
    assert got.p_imgs == ref.p_imgs and got.p_gts == ref.p_gts and len(got)
    assert got.name == "dut-omron"
    with pytest.raises(ValueError):
        get_dataset(str(tmp_path), "ecssd", "train")


def test_evaluator_needs_its_dataset(weights, tmp_path):
    _, model = weights
    with pytest.raises(FileNotFoundError):
        Evaluator(model, _cfg(tmp_path / "absent"), TCFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        Evaluator(model, _cfg(tmp_path), TCFG, device="cpu")("ecssd")


# --------------------------------------------------------------- Trainer, CLI

def _train_workspace(root, rng):
    from sod_tpu_torch.ops import rle

    _write_duts_te(root, rng)
    tr = root / "DUTS" / "DUTS-TR-Image"
    tr.mkdir()
    masks = {}
    for i in range(4):
        im = (rng.rand(40, 48, 3) * 50).astype(np.uint8)
        im[5:25, 10:30] += 170
        Image.fromarray(im).save(tr / f"tr_{i}.jpg")
        gt = np.zeros((32, 32), np.uint8)
        gt[4:20, 7:20] = 1
        masks[f"tr_{i}.jpg"] = rle.encode(gt)
    (root / "pm.json").write_text(json.dumps(masks))
    return dict(dir_ckpt=str(root / "ckpt"), dir_dataset=str(root),
                pseudo_masks_fp=str(root / "pm.json"), batch_size=4, num_workers=2,
                max_gt_masks=2, train_image_size=32, n_epochs=1, lr=1e-4,
                compute_dtype="float32")


def test_trainer_evaluates_and_keeps_the_best_model(tmp_path, rng):
    settings = _train_workspace(tmp_path, rng)
    trainer = Trainer(Config(**settings), device="cpu", mcfg=TCFG)
    trainer._train_epoch(1)
    res = trainer._evaluate(1)
    assert set(res) == {f"{k} (DUTS)" for k in (
        "iou", "pixel_accuarcy", "f_score", "f_max", "f_mean", "mae", "s_measure",
        "iou_ub", "pixel_accuarcy_ub", "f_score_ub", "f_max_ub", "f_mean_ub",
        "mae_ub", "s_measure_ub")}
    assert os.path.isfile(os.path.join(trainer.dir_ckpt, "best_model_duts.pt"))
    with open(os.path.join(trainer.dir_ckpt, "best_scores.json")) as f:
        assert json.load(f) == {"duts": res["iou (DUTS)"]}
    with open(os.path.join(trainer.dir_ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    skipped = {r["eval_skipped"] for r in records if "eval_skipped" in r}
    assert skipped == {"ecssd", "dut_omron"}              # not on disk
    assert records[-1]["iou (DUTS)"] == res["iou (DUTS)"]
    assert os.path.isfile(os.path.join(trainer.dir_ckpt, "eval", "duts", "01",
                                       "metrics_duts.txt"))


def test_trainer_skips_evaluation_without_datasets(tmp_path, rng):
    settings = _train_workspace(tmp_path, rng)
    trainer = Trainer(Config(**settings), device="cpu", mcfg=TCFG)
    trainer.cfg.dir_dataset = str(tmp_path / "absent")
    assert trainer._evaluate(1) == {}
    with open(os.path.join(trainer.dir_ckpt, "metrics.jsonl")) as f:
        record = json.loads(f.readlines()[-1])
    assert record["eval_skipped"] == "all" and "absent" in record["reason"]
    assert not any(n.startswith("best_model") for n in os.listdir(trainer.dir_ckpt))


@pytest.fixture()
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_prints_the_metric_dict(tmp_path, rng, capsys, two_threads):
    """The full-width live model on the four small test images."""
    _write_duts_te(tmp_path, rng)
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump({"dir_dataset": str(tmp_path), "num_workers": 2}))
    metrics = cli.main(["--config", str(fp), "--dataset_name", "duts", "--device", "cpu",
                        "--batch_size", "4", "--dir_root", str(tmp_path)])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):]) == metrics
    assert all(np.isfinite(v) for v in metrics.values()) and "iou_ub" in metrics


def test_cli_loads_a_checkpoint_of_the_trainer(tmp_path, rng, capsys, two_threads):
    """``--p_state_dict`` takes the port's own checkpoint file (the model
    under ``"model"``, beside the optimizer state) and scores those weights."""
    from sod_tpu_torch.models.maskformer import config_from, random_state_dict
    from sod_tpu_torch.train.checkpoints import save_checkpoint

    _write_duts_te(tmp_path, rng)
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump({"dir_dataset": str(tmp_path), "num_workers": 2}))
    cfg = Config(dir_dataset=str(tmp_path), num_workers=2)
    model = MaskFormer(config_from(cfg))
    model.load_state_dict(random_state_dict(model, 5))
    save_checkpoint(str(tmp_path / "best_model_duts.pt"), model, epoch=3, n_iters=9)
    metrics = cli.main(["--config", str(fp), "--dataset_name", "duts", "--device", "cpu",
                        "--batch_size", "4", "--dir_root", str(tmp_path),
                        "--p_state_dict", str(tmp_path / "best_model_duts.pt")])
    assert "Pre-trained weights are loaded" in capsys.readouterr().out
    assert metrics == Evaluator(model, cfg, batch_size=4, device="cpu")("duts")


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--tp", "2"], ["--sp", "2"],
                                   ["--tp", "2", "--sp", "2"], ["--tp", "4"],
                                   ["--sp", "9999"]])
def test_cli_refuses_mesh_flags(flags, monkeypatch):
    """Every flag is accepted as ``sod_tpu/cli/evaluate.py:38-43, 84-97``
    takes it: ``--n_devices 2`` spawns two ranks of the CLI, each evaluating
    its rows of every batch, ``--tp 2`` or ``--sp 2`` two ranks (one data
    rank on the CPU), both four, and ``--tp 4`` four, a model axis that cuts
    ViT-S's 6 heads (recorded here;
    ``tests/test_torch_data_parallel.py`` and
    ``tests/test_torch_model_parallel.py`` run the Evaluator on them); more
    ranks than the host has raise ``sod_tpu``'s ``ValueError``."""
    from sod_tpu_torch.parallel.mesh import device_limit

    argv = ["--config", "unused.yaml", "--device", "cpu", *flags]
    if flags == ["--sp", "9999"]:
        with pytest.raises(ValueError, match=f"requested 1x9999 devices, have "
                                             f"{device_limit('cpu')}"):
            cli.main(argv)
        return
    import sod_tpu_torch.parallel.mesh as mesh_mod

    spawned = []
    monkeypatch.setattr(mesh_mod, "spawn_ranks",
                        lambda fn, n, *args: spawned.append((fn, n, args)))
    assert cli.main(argv) == {}
    assert spawned == [(cli._rank_main, int(np.prod([int(v) for v in flags[1::2]])), (argv,))]


def test_eval_modules_import_no_jax():
    code = ("import sys; import sod_tpu_torch.cli.evaluate, sod_tpu_torch.train.evaluator, "
            "sod_tpu_torch.metrics.batched, sod_tpu_torch.metrics.f_measure, "
            "sod_tpu_torch.metrics.simple, sod_tpu_torch.data.factory; "
            "sys.exit(int('jax' in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
