"""The port's train step (``sod_tpu_torch/train/step.py``) against
``sod_tpu.train.step.make_train_step`` from the same weights
(``maskformer_init`` carried over by ``state_dict_from_jax``), the same
numpy batches and the same optimizer settings, at the small model of
``tests/test_torch_slice.py`` with ``use_pallas_attention`` on: sod_tpu's
flash attention runs its Pallas forward and backward kernels in interpret
mode, the port its K2 plain versions (CPU tensors).  lr is 1e-3 so that
the updates stand above f32 noise.

Tolerances and why:

* f32, two steps: loss and metrics <= 1e-5 relative plus 1e-6 absolute
  (f32 summation order; measured <= 1.2e-5 relative on a 0.005 ranking
  loss); the updates (new - old params) <= 1e-5 absolute (1% of lr) plus
  1e-3 relative.  Adam's first step is lr * g / (|g| + eps), so an element
  whose gradient is at f32 noise (the key biases' gradients are zero in
  exact arithmetic: softmax ignores a shift shared by all keys) takes a
  noise-signed update; measured: 7 of 256k elements above 1e-6, max 3.2e-6.
* bf16, one step, XLA's excess precision off (so XLA rounds every bf16 op
  as written, as the port does): loss and metrics <= 1e-3 relative
  (measured <= 4.8e-5); the whole update's correlation with sod_tpu's
  > 0.995 and >= 97% of its elements within 1e-5 (measured 0.99926 and
  98.1%).  The backward's bf16 roundings (GELU, attention) sit at other
  points in torch's autograd than in XLA's transposes, and Adam turns
  each gradient element that is small against that noise into a
  sign-sized update.
* accum_steps=2, "averaged": as f32.
* ``use_fused_train`` / ``use_fused_mlp`` (sod_tpu on the CPU runs K3's
  XLA twin under autodiff and K4's twin with its XLA backward; the port
  K3's twin in f32 and its plain kernel version in bf16, and K4's plain
  version): two steps each.  K4 rounds its matmul inputs to bf16 in f32
  runs too, so an f32 run carries bf16 rounding flips: f32 metrics <= 1e-4
  relative, f32 updates as the bf16 test (correlation > 0.995, >= 97% of
  the elements within 1e-5).  In bf16 the two sides' f32 sums run in another
  order (per-head products here, batched einsums in XLA), which flips single
  bf16 roundings (0.5% of the encoder's outputs by one ulp under
  ``fused_train``): metrics <= 5e-3 relative (measured <= 3.6e-3), except
  the ranking loss, a hinge over score gaps whose value is ~0.03: 5e-3
  absolute (measured 2.8e-3 on step two).  The first update as the bf16
  test; the second starts from parameters that already differ by Adam's
  sign-sized updates on noise-level gradient elements: correlation > 0.99,
  >= 80% within 1e-5 (measured 0.994 and 87%).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod_tpu.ops.flash_attention as jax_flash
from sod_tpu.config import Config
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.train.optim import build_optimizer as jax_build_optimizer
from sod_tpu.train.step import make_train_step as jax_make_train_step
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops import flash_attention as fa
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4,
           use_flash=True)
JCFG = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT))
TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT))
N_ITERS = 2


@pytest.fixture()
def interpret_k2(monkeypatch):
    """sod_tpu's flash attention on the CPU through its Pallas kernels in
    interpret mode (``_dispatch`` and ``_bwd`` look all three up at call
    time)."""
    monkeypatch.setattr(jax_flash, "_use_pallas", lambda: True)
    monkeypatch.setattr(jax_flash, "_flash_forward",
                        functools.partial(jax_flash._flash_forward, interpret=True))
    monkeypatch.setattr(jax_flash, "_flash_backward",
                        functools.partial(jax_flash._flash_backward, interpret=True))


def _batch(seed, b=4):
    r = np.random.default_rng(seed)
    gt = np.zeros((b, 2, 32, 32), np.uint8)
    valid = np.zeros((b, 2), bool)
    for i in range(b):
        y, x = r.integers(0, 14, 2)
        gt[i, 0, y:y + 12, x:x + 14] = 1
        valid[i, 0] = True
        if i % 2:
            gt[i, 1, 2:9, 3:20] = 1
            valid[i, 1] = True
    return {"image": r.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
            "gt_masks": gt, "gt_valid": valid,
            "labels": np.array([5, 5, 9, 9][:b], np.int32)}


def _cfg(dtype, accum=1):
    return Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                  compute_dtype=dtype, grad_accum_steps=accum)


def _run(cfg, batches, compiler_options=None, **vit_kw):
    """Both steps over ``batches``: per step (metrics, update) of each,
    the update as reference-layout arrays.  ``vit_kw``: ViTConfig switches
    set on both sides (``fused_train``, ``fused_mlp``)."""
    JCFG = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2,
                               vit=JaxViTConfig(**VIT, **vit_kw))
    TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2,
                            vit=ViTConfig(**VIT, **vit_kw))
    params = maskformer_init(jax.random.key(0), JCFG)
    model = MaskFormer(TCFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(jax.tree.map(np.asarray, params)).items()})
    opt = build_optimizer(cfg, model.parameters(), N_ITERS)
    step = make_train_step(cfg, model, opt, accum_steps=cfg.grad_accum_steps)
    tx = jax_build_optimizer(cfg, N_ITERS)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(cfg, tx, JCFG, accum_steps=cfg.grad_accum_steps)
    out = []
    for bt in batches:
        jb = {k: jnp.asarray(v) for k, v in bt.items()}
        fn = jstep
        if compiler_options:
            fn = jstep.lower(params, opt_state, jb).compile(
                compiler_options=compiler_options)
        old = state_dict_from_jax(jax.tree.map(np.asarray, params))
        params, opt_state, jm = fn(params, opt_state, jb)
        new = state_dict_from_jax(jax.tree.map(np.asarray, params))
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tm = step({k: torch.from_numpy(v) for k, v in bt.items()})
        after = model.state_dict()
        out.append(({k: float(jm[k]) for k in METRIC_KEYS},
                    {k: float(tm[k]) for k in METRIC_KEYS},
                    {k: new[k] - old[k] for k in new},
                    {k: (after[k] - before[k]).numpy() for k in after}))
    return out


def _check_metrics(jm, tm, rtol, contrastive=True):
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6, err_msg=k)
    assert jm["grad_norm"] > 1.0          # the clip is active
    # InfoNCE over two images with one positive pair is exactly 0
    assert (jm["contrastive_loss"] > 0) == contrastive


def test_fp32_steps_match_sod_tpu(interpret_k2):
    launches = (fa.fwd_launches, fa.bwd_launches)
    for jm, tm, ju, tu in _run(_cfg("float32"), [_batch(0), _batch(1)]):
        _check_metrics(jm, tm, rtol=1e-5)
        for k in ju:
            assert tu[k].shape == ju[k].shape, k
            np.testing.assert_allclose(tu[k], ju[k], atol=1e-5, rtol=1e-3,
                                       err_msg=k)
    assert (fa.fwd_launches, fa.bwd_launches) == launches   # plain versions


def test_bf16_step_matches_sod_tpu(interpret_k2):
    [(jm, tm, ju, tu)] = _run(_cfg("bfloat16"), [_batch(2)],
                              {"xla_allow_excess_precision": False})
    _check_metrics(jm, tm, rtol=1e-3)
    a = np.concatenate([tu[k].ravel() for k in sorted(tu)])
    b = np.concatenate([ju[k].ravel() for k in sorted(ju)])
    assert np.corrcoef(a, b)[0, 1] > 0.995
    assert np.mean(np.abs(a - b) <= 1e-5) >= 0.97


def _check_updates_bf16(ju, tu, min_corr=0.995, min_close=0.97):
    a = np.concatenate([tu[k].ravel() for k in sorted(tu)])
    b = np.concatenate([ju[k].ravel() for k in sorted(ju)])
    assert np.corrcoef(a, b)[0, 1] > min_corr
    assert np.mean(np.abs(a - b) <= 1e-5) >= min_close


@pytest.mark.parametrize("switch", ["fused_train", "fused_mlp"])
def test_fused_fp32_steps_match_sod_tpu(interpret_k2, switch):
    steps = _run(_cfg("float32"), [_batch(4), _batch(5)], **{switch: True})
    assert len(steps) == 2
    for jm, tm, ju, tu in steps:
        _check_metrics(jm, tm, rtol=1e-4)
        _check_updates_bf16(ju, tu)


@pytest.mark.parametrize("switch", ["fused_train", "fused_mlp"])
def test_fused_bf16_steps_match_sod_tpu(interpret_k2, switch):
    steps = _run(_cfg("bfloat16"), [_batch(6), _batch(7)],
                 {"xla_allow_excess_precision": False}, **{switch: True})
    assert len(steps) == 2
    for i, (jm, tm, ju, tu) in enumerate(steps):
        for k in METRIC_KEYS:
            tol = dict(rtol=0, atol=5e-3) if k == "ranking_loss" else \
                dict(rtol=5e-3, atol=1e-6)
            np.testing.assert_allclose(tm[k], jm[k], err_msg=f"{k} step {i}", **tol)
        assert jm["grad_norm"] > 1.0          # the clip is active
        _check_updates_bf16(ju, tu, *((0.995, 0.97) if i == 0 else (0.99, 0.80)))


def test_averaged_accumulation_matches_sod_tpu(interpret_k2):
    [(jm, tm, ju, tu)] = _run(_cfg("float32", accum=2), [_batch(3)])
    _check_metrics(jm, tm, rtol=1e-5, contrastive=False)
    for k in ju:
        np.testing.assert_allclose(tu[k], ju[k], atol=1e-5, rtol=1e-3, err_msg=k)


def test_exact_accumulation_is_refused():
    """Refused only as ``sod_tpu`` refuses it: an unknown mode raises its
    ``ValueError``; ``"exact"`` builds a step that trains (its values are
    held in ``tests/test_torch_train_options.py``)."""
    model = MaskFormer(TCFG)
    model.load_state_dict(random_state_dict(model, 0))
    cfg = _cfg("float32", accum=2)
    opt = build_optimizer(cfg, model.parameters(), 2)
    with pytest.raises(ValueError, match="'averaged' or 'exact'"):
        make_train_step(cfg, model, opt, accum_steps=2, mode="gradcache")
    step = make_train_step(cfg, model, opt, accum_steps=2, mode="exact")
    metrics = step({k: torch.from_numpy(v) for k, v in _batch(8).items()})
    assert all(np.isfinite(float(metrics[k])) for k in METRIC_KEYS)
    assert float(metrics["contrastive_loss"]) > 0 and opt.count == 1
