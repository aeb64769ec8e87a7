"""The training options of ROADMAP item 6 on the CPU at a tiny size (ViT
d 64, 2 heads, depth 2, 32 px, 2 decoder layers, 4 queries), against
``sod_tpu`` from the same weights (``state_dict_from_jax``) and against the
port's own paths.  ``sod_tpu``'s flash attention runs its Pallas kernels in
interpret mode, the port its K2 plain versions.

* exact accumulation (GradCache), f32: the parameters after one update
  within 1e-4 of ``sod_tpu``'s exact step (metrics within 1e-5 relative);
  at 2 micro-batches against one micro-batch, the metrics within 1e-5
  relative and each summed gradient within 1e-5 of its largest element
  (``sod_tpu``'s "exact up to reassociation"; measured <= 3.4e-7), with the
  labels repeated across the micro-batches so that positive pairs span
  them, and one image with no valid mask so that the normalisation is
  global;
* remat: gradients and metrics bit-equal to the step without it, each
  block's forward run twice; against ``sod_tpu``'s remat step as
  ``test_torch_train_step.py``'s f32 steps;
* ``AsyncSaver``: the file equals the state at ``save`` bit for bit after
  the model and the moments were changed in place while the write waited;
  the Trainer's async ``latest_model.pt`` equals the synchronous one's;
* ``get_lr_scheduler``, ``dropout`` / ``drop_path``, ``denormalize``,
  ``make_eval_step``, ``BaseStructure`` and the visualizer hooks of the
  Trainer and the Evaluator.
"""
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sod_tpu.ops.flash_attention as jax_flash
from sod_tpu.config import Config
from sod_tpu.data.augment import denormalize as jax_denormalize
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.train.base_structure import BaseStructure as JaxBaseStructure
from sod_tpu.train.evaluator import Evaluator as JaxEvaluator
from sod_tpu.train.optim import build_optimizer as jax_build_optimizer
from sod_tpu.train.optim import get_lr_scheduler as jax_get_lr_scheduler
from sod_tpu.train.step import make_eval_step as jax_make_eval_step
from sod_tpu.train.step import make_train_step as jax_make_train_step
from sod_tpu_torch.data.augment import denormalize, normalize
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops import rle
from sod_tpu_torch.ops.layers import drop_path, dropout
from sod_tpu_torch.train import checkpoints
from sod_tpu_torch.train.base_structure import BaseStructure
from sod_tpu_torch.train.checkpoints import AsyncSaver, restore_checkpoint
from sod_tpu_torch.train.evaluator import Evaluator
from sod_tpu_torch.train.optim import build_optimizer, get_lr_scheduler
from sod_tpu_torch.train.step import METRIC_KEYS, make_eval_step, make_train_step
from sod_tpu_torch.train.trainer import Trainer
from sod_tpu_torch.utils.visualizer import Visualizer

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
N_ITERS = 2


def _configs(use_flash=True, bc=True, **vit_kw):
    vit = dict(VIT, use_flash=use_flash, **vit_kw)
    return (JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2, use_binary_classifier=bc,
                                vit=JaxViTConfig(**vit)),
            MaskFormerConfig(n_queries=4, n_decoder_layers=2, use_binary_classifier=bc,
                             vit=ViTConfig(**vit)))


def _shared(jcfg, tcfg, seed=0):
    """``sod_tpu``'s params and the port's model with the same weights."""
    params = maskformer_init(jax.random.key(seed), jcfg)
    model = MaskFormer(tcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(jax.tree.map(np.asarray, params)).items()})
    return params, model


@pytest.fixture()
def interpret_k2(monkeypatch):
    """sod_tpu's flash attention on the CPU through its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(jax_flash, "_use_pallas", lambda: True)
    monkeypatch.setattr(jax_flash, "_flash_forward",
                        functools.partial(jax_flash._flash_forward, interpret=True))
    monkeypatch.setattr(jax_flash, "_flash_backward",
                        functools.partial(jax_flash._flash_backward, interpret=True))


def _batch(seed, b=4):
    """Labels repeated across the two micro-batches (5, 9 | 5, 9): the
    positive pairs span them; the last image has no valid mask."""
    r = np.random.default_rng(seed)
    gt = np.zeros((b, 2, 32, 32), np.uint8)
    valid = np.zeros((b, 2), bool)
    for i in range(b - 1):
        y, x = r.integers(0, 14, 2)
        gt[i, 0, y:y + 12, x:x + 14] = 1
        valid[i, 0] = True
        if i % 2:
            gt[i, 1, 2:9, 3:20] = 1
            valid[i, 1] = True
    return {"image": r.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
            "gt_masks": gt, "gt_valid": valid,
            "labels": np.array([5, 9, 5, 9][:b], np.int32)}


def _cfg(accum=1, mode="averaged", **kw):
    return Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                  compute_dtype="float32", grad_accum_steps=accum,
                  grad_accum_mode=mode, **kw)


def _torch_batch(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


def _port_step(cfg, model, batch):
    """One step of the port: (metrics, {name: grad}, {name: new param})."""
    opt = build_optimizer(cfg, model.parameters(), N_ITERS)
    step = make_train_step(cfg, model, opt, accum_steps=cfg.grad_accum_steps,
                           mode=cfg.grad_accum_mode)
    m = step(_torch_batch(batch))
    return ({k: float(m[k]) for k in METRIC_KEYS},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _jax_step(cfg, jcfg, params, batch):
    tx = jax_build_optimizer(cfg, N_ITERS)
    step = jax_make_train_step(cfg, tx, jcfg, accum_steps=cfg.grad_accum_steps,
                               mode=cfg.grad_accum_mode)
    params, _, m = step(params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(m[k]) for k in METRIC_KEYS},
            state_dict_from_jax(jax.tree.map(np.asarray, params)))


# ------------------------------------------------------------ exact mode

def test_exact_step_matches_sod_tpu(interpret_k2):
    jcfg, tcfg = _configs()
    params, model = _shared(jcfg, tcfg)
    cfg, batch = _cfg(accum=2, mode="exact"), _batch(0)
    jm, jparams = _jax_step(cfg, jcfg, params, batch)
    tm, _, tparams = _port_step(cfg, model, batch)
    assert jm["contrastive_loss"] > 0 and jm["grad_norm"] > 1.0   # both terms, clipped
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["flash", "plain_attention", "no_contrastive_term",
                                  "no_labels"])
def test_exact_equals_one_micro_batch(case):
    """2 micro-batches in exact mode against the whole batch at once, from
    the same weights: gradients and metrics within 1e-5."""
    _, tcfg = _configs(use_flash=case != "plain_attention")
    extra = {"weight_contrastive_loss": 0.0} if case == "no_contrastive_term" else {}
    batch = _batch(1)
    if case == "no_labels":
        del batch["labels"]
    sd = random_state_dict(MaskFormer(tcfg), 3)
    runs = []
    for accum, mode in ((1, "averaged"), (2, "exact")):
        model = MaskFormer(tcfg)
        model.load_state_dict(sd)
        runs.append(_port_step(_cfg(accum, mode, **extra), model, batch))
    (m1, g1, _), (m2, g2, _) = runs
    if case == "no_contrastive_term":
        # as sod_tpu's: the one-batch step reports the unweighted InfoNCE,
        # exact mode skips pass 1 and reports 0
        assert m1["contrastive_loss"] > 0 and m2["contrastive_loss"] == 0.0
        m1["contrastive_loss"] = 0.0
    for k in METRIC_KEYS:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert (m1["contrastive_loss"] > 0) == (case in ("flash", "plain_attention"))
    for n in g1:
        # per tensor, against its largest element: the key biases' gradients
        # are 0 in exact arithmetic and sit at the f32 noise of the others
        err = float((g2[n] - g1[n]).abs().max())
        assert err <= 1e-5 * float(g1[n].abs().max()), (n, err)


def test_exact_passes_share_one_forward():
    """Pass 1's features equal pass 2's bit for bit (same forward, K2's
    plain version here), and pass 1 runs without gradients."""
    _, tcfg = _configs()
    model = MaskFormer(tcfg)
    model.load_state_dict(random_state_dict(model, 4))
    seen = []
    model.register_forward_hook(
        lambda mod, args, out: seen.append((torch.is_grad_enabled(),
                                            out["features"].detach().clone())))
    _port_step(_cfg(2, "exact"), model, _batch(2))
    assert [g for g, _ in seen] == [False, False, True, True]
    for (_, z1), (_, z2) in zip(seen[:2], seen[2:]):
        assert torch.equal(z1, z2)


# ------------------------------------------------------------ remat

@pytest.mark.parametrize("switch", ["plain_attention", "flash", "fused_mlp", "flash_bf16",
                                    "fused_train"])
def test_remat_gradients_are_bit_equal(switch):
    """One step with and without remat from the same weights; under remat
    every unfused block's forward runs again in the backward (under
    ``fused_train`` the K3 + K4 path wins and remat is ignored)."""
    vit_kw = {"fused_mlp": {"fused_mlp": True},
              "fused_train": {"fused_train": True}}.get(switch, {})
    sd = None
    runs = []
    for remat in (False, True):
        _, tcfg = _configs(use_flash=switch != "plain_attention", remat=remat, **vit_kw)
        model = MaskFormer(tcfg)
        sd = sd or random_state_dict(model, 5)
        model.load_state_dict(sd)
        calls = []
        for blk in model.encoder.blocks:
            blk.register_forward_pre_hook(lambda mod, args: calls.append(1))
        dtype = "bfloat16" if switch == "flash_bf16" else "float32"
        cfg = Config(batch_size=4, lr=1e-3, n_epochs=2, compute_dtype=dtype)
        runs.append((_port_step(cfg, model, _batch(3)), len(calls)))
    ((m0, g0, _), calls0), ((m1, g1, _), calls1) = runs
    assert m0 == m1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert calls0 == (0 if switch == "fused_train" else 2)
    assert calls1 == (0 if switch == "fused_train" else 4)


def test_remat_step_matches_sod_tpu(interpret_k2):
    jcfg, tcfg = _configs(remat=True)
    params, model = _shared(jcfg, tcfg)
    cfg, batch = _cfg(), _batch(4)
    old = {k: v.clone() for k, v in model.state_dict().items()}
    jold = state_dict_from_jax(jax.tree.map(np.asarray, params))
    jm, jparams = _jax_step(cfg, jcfg, params, batch)
    tm, _, tparams = _port_step(cfg, model, batch)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in jparams.items():
        np.testing.assert_allclose((tparams[k] - old[k]).numpy(), v - jold[k],
                                   atol=1e-5, rtol=1e-3, err_msg=k)


# ------------------------------------------------------------ checkpoints

def _tiny_model_and_optimizer(seed=6):
    _, tcfg = _configs()
    model = MaskFormer(tcfg)
    model.load_state_dict(random_state_dict(model, seed))
    opt = build_optimizer(_cfg(), model.parameters(), N_ITERS)
    make_train_step(_cfg(), model, opt)(_torch_batch(_batch(5)))   # moments set
    return model, opt


def test_async_saver_snapshots_before_save_returns(tmp_path, monkeypatch):
    """The write is held until the model's parameters and the optimizer's
    moments were changed in place; the file holds the state at ``save``."""
    model, opt = _tiny_model_and_optimizer()
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = opt.state_dict()
    release = threading.Event()
    write = checkpoints.write_checkpoint

    def held_write(path, payload):
        assert release.wait(30)
        write(path, payload)

    monkeypatch.setattr(checkpoints, "write_checkpoint", held_write)
    saver = AsyncSaver()
    fp = str(tmp_path / "latest_model.pt")
    saver.save(fp, model, opt, epoch=3, n_iters=7, extra={"best_scores": {"duts": 0.5}})
    assert not os.path.exists(fp)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for t in opt.mu + opt.nu:
            t.mul_(-2.0)
    release.set()
    saver.wait()
    state = restore_checkpoint(fp)
    assert (state["epoch"], state["n_iters"], state["extra"]) == (
        3, 7, {"best_scores": {"duts": 0.5}})
    assert state["model"].keys() == want_model.keys()
    for k, v in want_model.items():
        assert torch.equal(state["model"][k], v), k
    assert state["optimizer"]["count"] == want_opt["count"]
    for a, b in zip(state["optimizer"]["mu"] + state["optimizer"]["nu"],
                    want_opt["mu"] + want_opt["nu"]):
        assert torch.equal(a, b)


def test_async_saver_reraises_a_failed_write(tmp_path, monkeypatch):
    def failing(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints, "write_checkpoint", failing)
    model, opt = _tiny_model_and_optimizer()
    saver = AsyncSaver()
    saver.save(str(tmp_path / "x.pt"), model, opt)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()                              # reported once


def _write_duts_tr(root, n=8):
    tr = root / "DUTS" / "DUTS-TR-Image"
    tr.mkdir(parents=True)
    r = np.random.default_rng(0)
    masks = {}
    for i in range(n):
        im = (r.random((40, 48, 3)) * 50).astype(np.uint8)
        im[5:25, 10:30] += 170
        Image.fromarray(im).save(tr / f"tr_{i}.jpg")
        gt = np.zeros((32, 32), np.uint8)
        gt[4 + i:20, 7:20] = 1
        masks[f"tr_{i}.jpg"] = rle.encode(gt)
    (root / "pm.json").write_text(json.dumps(masks))


def _trainer_cfg(root, **kw):
    return Config(dir_ckpt=str(root / "ckpt"), dir_dataset=str(root),
                  pseudo_masks_fp=str(root / "pm.json"), batch_size=4, num_workers=2,
                  max_gt_masks=2, train_image_size=32, n_epochs=2, lr=1e-4,
                  compute_dtype="float32", **kw)


def test_trainer_async_checkpoint_equals_the_synchronous_one(tmp_path):
    _write_duts_tr(tmp_path)
    _, tcfg = _configs()
    files = {}
    for mode in (False, True):
        trainer = Trainer(_trainer_cfg(tmp_path, async_checkpoint=mode,
                                       suffix=f"async{int(mode)}"), device="cpu", mcfg=tcfg)
        assert (trainer._ckpt_saver is not None) == mode
        for epoch in (1, 2):
            trainer._train_epoch(epoch)
        trainer.wait_for_checkpoints()
        files[mode] = restore_checkpoint(trainer.latest_path)
    sync, asyn = files[False], files[True]
    assert (asyn["epoch"], asyn["n_iters"]) == (sync["epoch"], sync["n_iters"]) == (2, 4)
    for k, v in sync["model"].items():
        assert torch.equal(asyn["model"][k], v), k
    for a, b in zip(sync["optimizer"]["mu"] + sync["optimizer"]["nu"],
                    asyn["optimizer"]["mu"] + asyn["optimizer"]["nu"]):
        assert torch.equal(a, b)
    fresh = Trainer(_trainer_cfg(tmp_path, async_checkpoint=True, suffix="async1"),
                    device="cpu", mcfg=tcfg)
    assert fresh.resume() == 3 and fresh.optimizer.count == 4


# ------------------------------------------------------------ small pieces

@pytest.mark.parametrize("kwargs", [{}, {"cycle_iters": 5}, {"power": 2.0}])
def test_lr_scheduler_equals_sod_tpus(kwargs):
    cfg = Config(lr=1e-3, n_epochs=3, lr_warmup_duration=1)
    ours = get_lr_scheduler(cfg, 5, **kwargs)
    theirs = jax_get_lr_scheduler(cfg, 5, **kwargs)
    got = [ours(t) for t in range(17)]
    assert all(isinstance(v, np.float32) for v in got)
    assert got == [np.float32(theirs(t)) for t in range(17)]
    with pytest.raises(ValueError, match=r"currently \[poly\] supported") as ours_err:
        get_lr_scheduler(cfg, 5, mode="cosine")
    with pytest.raises(ValueError) as theirs_err:
        jax_get_lr_scheduler(cfg, 5, mode="cosine")
    assert str(ours_err.value) == str(theirs_err.value)


@pytest.mark.parametrize("fn", [dropout, drop_path])
def test_dropout_and_drop_path(fn):
    x = torch.randn(4096, 3, 8)
    g = torch.Generator().manual_seed(0)
    assert fn(x, 0.0, g) is x and fn(x, 0.3, None) is x        # the identity cases
    y = fn(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(y, fn(x, 0.25, torch.Generator().manual_seed(1)))   # seeded
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    if fn is drop_path:                       # one draw per sample
        per_sample = kept.reshape(4096, -1)
        assert torch.equal(per_sample.all(1), per_sample.any(1))
    half = fn(x.to(torch.bfloat16), 0.5, torch.Generator().manual_seed(2))
    assert half.dtype == torch.bfloat16


def test_denormalize_equals_sod_tpus():
    r = np.random.default_rng(7)
    img = normalize(r.integers(0, 256, (21, 17, 3)).astype(np.float32))
    img[0, 0] = 9.0                                    # clipped at 255
    img[0, 1] = -9.0                                   # clipped at 0
    np.testing.assert_array_equal(denormalize(img), jax_denormalize(img))


def test_make_eval_step_matches_sod_tpus():
    """f32, uint8 input normalised on the device; ``fused`` in f32 runs
    the unfused blocks on both sides.  ``apply_fn`` (the model-sharding
    layouts' forward) takes the model's place: here the model's own
    forward, so the same outputs."""
    jcfg, tcfg = _configs(use_flash=False)
    params, model = _shared(jcfg, tcfg)
    cfg = _cfg()
    u8 = np.random.default_rng(8).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref = jax_make_eval_step(cfg, jcfg)(params, jnp.asarray(u8))
    got = make_eval_step(cfg, model)(torch.from_numpy(u8))
    for k in ("mask_pred", "objectness"):
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    calls = []
    hooked = make_eval_step(cfg, model, apply_fn=lambda m, x: calls.append(x.dtype) or m(x))(
        torch.from_numpy(u8))
    assert calls == [torch.float32]
    for k in ("mask_pred", "objectness"):
        assert torch.equal(hooked[k], got[k])


@pytest.mark.parametrize("bc", [True, False])
def test_base_structure_forward_and_pngs(tmp_path, bc):
    """``_forward`` (NCHW numpy input, and ``encoder_only``) against
    ``sod_tpu``'s, f32 within 1e-4; ``_visualize`` writes the grid PNG (bc:
    the argmax-objectness query selected; non-bc: no objectness)."""
    jcfg, tcfg = _configs(use_flash=False, bc=bc)
    params, model = _shared(jcfg, tcfg)
    cfg = _cfg(use_binary_classifier=bc)
    x = normalize(np.random.default_rng(9).integers(0, 256, (32, 32, 3)).astype(np.float32))
    nchw = {"x": x.transpose(2, 0, 1)}
    ours = BaseStructure(model, cfg, visualizer=Visualizer(str(tmp_path)))
    theirs = JaxBaseStructure(params, cfg, jcfg)
    out, ref = ours._forward(nchw), theirs._forward(nchw)
    assert ("objectness" in out) == bc and out.keys() == ref.keys()
    for k in out:
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(ref[k]), atol=1e-4,
                                   err_msg=k)
    enc, enc_ref = (s._forward(nchw, encoder_only=True)["patch_tokens"] for s in (ours, theirs))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=1e-4)
    gt = np.zeros((32, 32), np.uint8)
    gt[8:20, 4:30] = 1
    fp = ours._visualize({"image": x, "m": gt}, out, "grids/one.png")
    with Image.open(fp) as im:
        assert im.format == "PNG" and min(im.size) > 100
    sel = ours._extract_selected_predictions(out["mask_pred"][:, -1], [2])
    np.testing.assert_array_equal(sel, out["mask_pred"][:, -1, 2].numpy())
    if not bc:                               # the evaluator's argmax composition
        fp = ours.visualizer.eval_grid(denormalize(x), gt, out["mask_pred"][0, -1].numpy(),
                                       None, "grids/composed.png")
        assert os.path.isfile(fp)


class _Recording:
    """A visualizer that keeps its calls' arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, epoch, it, batch, outputs=None):
        self.calls.append((epoch, it, batch, outputs))

    def eval_grid(self, image_u8, gt_mask, pred_masks, objectness, fp):
        self.calls.append((image_u8, gt_mask, pred_masks, objectness, fp))


def test_trainer_visualizer_hook(tmp_path):
    """8 images at batch 4: two iterations, both rendered (every
    ``len(loader) // 10`` = every iteration); the outputs are the current
    weights' ``make_eval_step`` on the batch's first image."""
    _write_duts_tr(tmp_path)
    _, tcfg = _configs()
    rec = _Recording()
    trainer = Trainer(_trainer_cfg(tmp_path), device="cpu", mcfg=tcfg, visualizer=rec)
    trainer._train_epoch(1)
    assert [(e, i) for e, i, _, _ in rec.calls] == [(1, 0), (1, 1)]
    _, _, batch, outs = rec.calls[-1]
    want = make_eval_step(trainer.cfg, trainer.model)(torch.from_numpy(batch["image"][:1]))
    for k in ("mask_pred", "objectness"):
        np.testing.assert_array_equal(outs[k], want[k].numpy())
    assert outs["mask_pred"].shape == (1, 4, 8, 8) and outs["objectness"].shape == (1, 4)
    trainer.visualizer = Visualizer(str(tmp_path / "vis"))
    trainer._train_epoch(2)
    assert sorted(os.listdir(tmp_path / "vis" / "02")) == ["00000.png", "00001.png"]


def test_evaluator_visualizer_matches_sod_tpus(tmp_path):
    """Both Evaluators with a recording visualizer on a 3-image DUTS-TE at
    batch 2, every batch rendered: the crops, objectness and masks of the
    first image of each batch (masks within one uint8 level), then PNGs."""
    te, gtd = tmp_path / "DUTS" / "DUTS-TE-Image", tmp_path / "DUTS" / "DUTS-TE-Mask"
    te.mkdir(parents=True)
    gtd.mkdir(parents=True)
    r = np.random.default_rng(10)
    for i, (h, w) in enumerate([(40, 48), (32, 32), (56, 24)]):
        img = (r.random((h, w, 3)) * 60).astype(np.uint8)
        img[h // 4:3 * h // 4, w // 5:4 * w // 5] += 150
        Image.fromarray(img).save(te / f"te_{i}.jpg")
        gt = np.zeros((h, w), np.uint8)
        gt[h // 4:3 * h // 4, w // 5:4 * w // 5] = 255
        Image.fromarray(gt).save(gtd / f"te_{i}.png")
    jcfg, tcfg = _configs(use_flash=False)
    params, model = _shared(jcfg, tcfg)
    cfg = Config(dir_dataset=str(tmp_path), compute_dtype="float32", num_workers=2)
    recs = [_Recording(), _Recording()]
    JaxEvaluator(params, cfg, jcfg, visualizer=recs[0], batch_size=2, vis_every=1)("duts")
    Evaluator(model, cfg, tcfg, visualizer=recs[1], batch_size=2, vis_every=1)("duts")
    assert len(recs[0].calls) == len(recs[1].calls) == 2
    for (ji, jg, jp, jo, jf), (ti, tg, tp, to, tf) in zip(recs[0].calls, recs[1].calls):
        assert tf == jf and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_allclose(to, jo, atol=1e-4)
        assert tp.shape == jp.shape and np.abs(tp - jp).max() <= 1 / 255 + 1e-7
    Evaluator(model, cfg, tcfg, visualizer=Visualizer(str(tmp_path / "vis")), batch_size=2,
              vis_every=1)("duts")
    assert sorted(os.listdir(tmp_path / "vis" / "duts")) == ["00000.png", "00001.png"]
