"""The frozen references of ``sodbench/reference/`` against the program's
plain paths, on the CPU at a tiny size and in f32: the same weights and
inputs give the same forward, criterion, optimizer step and metrics."""
import math

import numpy as np
import pytest
import torch

from sodbench import inputs
from sodbench.reference import evaluate as ref_eval
from sodbench.reference import model as ref
from sodbench.reference import train as ref_train

from sod_tpu_torch.config import Config
from sod_tpu_torch.losses.criterion import criterion_forward
from sod_tpu_torch.models.maskformer import MaskFormer, config_from, maskformer_apply_canvas
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import make_train_step

ARCHS = ("vit_small", "resnet50")
# The random-init dilated ResNet-50 amplifies f32 summation order: its mask
# logits reach the tens, so a relative 1e-5 moves a sigmoid near 0.5 by
# ~1e-3, and Adam's first steps flip on gradients near its eps.
MASK_ATOL = {"vit_small": 1e-4, "resnet50": 2e-3}
CHANGE_RTOL = {"vit_small": 1e-3, "resnet50": 5e-3}


def _model(arch: str, seed: int = 5):
    cfg = Config(arch=arch, compute_dtype="float32", batch_size=2)
    specs = ref.param_specs(arch)
    w = ref.make_weights(specs, inputs.generator(seed, 0, "cpu"), "cpu")
    m = MaskFormer(config_from(cfg))
    m.load_state_dict(w)
    return cfg, m, w


def _batch(b=2, s=32, seed=3):
    g = inputs.generator(seed, 0, "cpu")
    masks, valid = inputs.ellipse_masks(g, b, 4, s, s, (1, 3), "cpu")
    return {"image": inputs.images(g, b, s, s, "cpu"), "gt_masks": masks, "gt_valid": valid,
            "labels": torch.tensor([0, 0, 1, 1][:b], dtype=torch.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_name_every_tensor_of_the_program(arch):
    specs = ref.param_specs(arch)
    sd = MaskFormer(config_from(Config(arch=arch))).state_dict()
    assert [n for n, *_ in specs] == list(sd) or sorted(n for n, *_ in specs) == sorted(sd)
    assert {n: tuple(s) for n, s, *_ in specs} == {k: tuple(v.shape) for k, v in sd.items()}


def test_weights_follow_the_seed():
    specs = ref.param_specs("vit_small")
    a, b, c = (ref.make_weights(specs, inputs.generator(s, 0, "cpu"), "cpu")
               for s in (7, 7, 2 ** 33 + 7))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_embed"], c["query_embed"])
    assert float(a["encoder.blocks.0.attn.qkv.weight"].std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_program_in_f32(arch):
    cfg, m, w = _model(arch)
    batch = _batch()
    from sod_tpu_torch.data.augment import normalize_device

    with torch.no_grad():
        got = m(normalize_device(batch["image"]), train=True)
        want = ref.forward(w, batch["image"], arch, train=True)
    assert torch.allclose(got["mask_pred"], want["mask_pred"], atol=MASK_ATOL[arch])
    assert torch.allclose(got["objectness"][..., 0], want["objectness"], atol=1e-4)
    assert torch.allclose(got["features"], want["features"], atol=1e-4)


def test_criterion_matches_the_program():
    torch.manual_seed(0)
    b, l, q = 4, 6, 20
    out = {"mask_pred": torch.rand(b, l, q, 8, 8), "objectness": torch.rand(b, l, q),
           "features": torch.randn(b, 384)}
    batch = _batch(b=4)
    want = criterion_forward(out["mask_pred"], batch["gt_masks"].float(), batch["gt_valid"],
                             out["objectness"][..., None], use_classification_loss=False,
                             features=out["features"], feature_labels=batch["labels"],
                             weight_contrastive_loss=0.1, temperature=0.07)["loss"]
    got = ref_train.criterion(out, batch, 0.1, 0.07)
    assert float(got) == pytest.approx(float(want), rel=2e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_program_in_f32(arch):
    cfg, m, w = _model(arch)
    batch = _batch()
    opt = build_optimizer(cfg, m.parameters(), n_iters_per_epoch=330)
    loss = float(make_train_step(cfg, m, opt)(batch)["loss"])
    out = ref_train.train_steps(w, [batch], cfg.to_dict(), arch, cfg.n_epochs * 330)
    assert out["losses"][0] == pytest.approx(loss, rel=1e-5)
    for name, p in m.named_parameters():
        change_prog = float((p.detach() - w[name]).norm())
        change_ref = float((out["params"][name] - w[name]).norm())
        assert change_prog == pytest.approx(change_ref, rel=CHANGE_RTOL[arch], abs=1e-9), name


def test_canvas_masks_match_the_program_in_f32():
    cfg, m, w = _model("vit_small")
    from sod_tpu_torch.train.evaluator import canvas_inputs

    g = inputs.generator(9, 0, "cpu")
    canvas = torch.zeros(2, 48, 48, 3, dtype=torch.uint8)
    sizes = [(40, 27), (48, 48)]
    imgs = [inputs.images(g, 1, h, w_, "cpu")[0] for h, w_ in sizes]
    for i, ((h, w_), im) in enumerate(zip(sizes, imgs)):
        canvas[i, :h, :w_] = im
    grid = torch.tensor([[math.ceil(h / 8), math.ceil(w_ / 8)] for h, w_ in sizes])
    with torch.no_grad():
        x, tmask, pe = canvas_inputs(m, canvas, grid, torch.float32)
        out = maskformer_apply_canvas(m, x, tmask, pe, grid, last_layer_only=True)
        from sod_tpu_torch.ops.resize import bilinear_separable

        prog = bilinear_separable(out["mask_pred"][:, -1], 48, 48)
        for i, ((h, w_), im) in enumerate(zip(sizes, imgs)):
            r = ref_eval.canvas_masks(w, im, 6)
            assert torch.allclose(prog[i, :, :h, :w_], r["masks"], atol=1e-4)
            assert torch.allclose(out["objectness"][i, -1, :, 0], r["objectness"], atol=1e-4)


def test_metrics_match_the_program():
    from sod_tpu_torch.metrics.batched import rect_metrics
    from sod_tpu_torch.ops.fsweep import fmax_tp_cnt

    torch.manual_seed(1)
    h, w = 37, 29
    pred = torch.sigmoid(torch.randn(1, h, w) * 2)
    gt = torch.zeros(1, h, w)
    gt[0, 5:25, 4:20] = 1
    tp, cnt = fmax_tp_cnt(pred[:, None], gt, torch.ones(1, h, dtype=torch.bool),
                          torch.ones(1, w, dtype=torch.bool))
    want = rect_metrics(pred, gt, torch.tensor([h]), torch.tensor([w]), (tp[:, 0], cnt[:, 0]))
    got = ref_eval.mask_metrics(pred[0], gt[0] > 0)
    names = dict(zip(ref_eval.METRICS, ("iou", "pixel_acc", "f_measure", "f_max", "f_mean",
                                        "mae", "s_measure")))
    for k, pk in names.items():
        assert got[k] == pytest.approx(float(want[pk][0]), abs=2e-6), k


def test_fp8_control_rounds_the_products():
    a = torch.randn(64, 64)
    q = ref._fp8(a)
    assert not torch.equal(q, a)
    assert float((q - a).abs().max()) <= float(a.abs().max()) * 2 ** -4
    assert np.unique(q.numpy()).size <= 256
