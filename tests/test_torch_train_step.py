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
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig
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


def _run(cfg, batches, compiler_options=None):
    """Both steps over ``batches``: per step (metrics, update) of each,
    the update as reference-layout arrays."""
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


def test_averaged_accumulation_matches_sod_tpu(interpret_k2):
    [(jm, tm, ju, tu)] = _run(_cfg("float32", accum=2), [_batch(3)])
    _check_metrics(jm, tm, rtol=1e-5, contrastive=False)
    for k in ju:
        np.testing.assert_allclose(tu[k], ju[k], atol=1e-5, rtol=1e-3, err_msg=k)


def test_exact_accumulation_is_refused():
    model = MaskFormer(TCFG)
    cfg = _cfg("float32", accum=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        make_train_step(cfg, model, build_optimizer(cfg, model.parameters(), 2),
                        accum_steps=2, mode="exact")
