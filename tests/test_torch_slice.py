"""The port's ``/predict`` forward as a whole against ``sod_tpu``'s, on the
same weights (``maskformer_init`` carried over by ``state_dict_from_jax``)
and the same numpy images, at a small size: ViT d 64, 2 heads, depth 2;
2 decoder layers; 4 queries.

* f32: ``MaskFormer.forward`` against ``maskformer_apply``, <= 1e-4 (the
  ``tests/test_convert.py`` standard) on ``mask_pred``, ``objectness`` and
  ``features``, at 32x32, at 40x24 (bicubic pos-embed resize) and at
  35x21 (zero-padded to the patch grid first).
* bf16 fused: the port (the kernel's plain version on the CPU) against
  ``maskformer_apply(fused=True)`` running K1 in interpret mode.  Compiled
  with ``xla_allow_excess_precision`` off, XLA rounds every bf16 op as
  written and the two agree to f32 noise: <= 1e-3 on the sigmoids, one bf16
  ulp on ``features``.  With XLA's default excess precision the decoder's
  bf16 adds stay in f32 in sod_tpu, so the gap grows to a few bf16 ulps of
  the mask logits: <= 0.05 on the sigmoids, correlation > 0.9999.  Either
  way the query the port serves has sod_tpu's highest objectness, up to
  the tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod_tpu.ops.fused_block as jax_fused_block
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_apply, maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.models.vit import vit_apply as jax_vit_apply
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, config_from
from sod_tpu_torch.models.vit import ViTConfig, vit_apply

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
JCFG = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT))
TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT))
KEYS = ("mask_pred", "objectness", "features")


@pytest.fixture(scope="module")
def weights():
    params = maskformer_init(jax.random.key(0), JCFG)
    model = MaskFormer(TCFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(jax.tree.map(np.asarray, params)).items()})
    return params, model.eval()


@pytest.fixture()
def interpret_k1(monkeypatch):
    """sod_tpu's fused path on the CPU: K1 in interpret mode (``vit_apply``
    imports both names at call time)."""
    monkeypatch.setattr(jax_fused_block, "fused_available", lambda: True)
    monkeypatch.setattr(jax_fused_block, "fused_vit_block",
                        functools.partial(jax_fused_block.fused_vit_block,
                                          interpret=True))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t.astype(jnp.float32)))


@pytest.mark.parametrize("hw", [(32, 32), (40, 24), (35, 21)])
def test_fp32_forward_matches_sod_tpu(weights, rng, hw):
    params, model = weights
    x = rng.randn(2, *hw, 3).astype(np.float32)
    ref = maskformer_apply(params, jnp.asarray(x), JCFG)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for k in KEYS:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), atol=1e-4, rtol=0,
                                   err_msg=k)


def test_bf16_fused_encoder_matches_interpret_kernel(weights, rng, interpret_k1):
    params, model = weights
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ref = jax_vit_apply(p16["encoder"], jnp.asarray(x).astype(jnp.bfloat16),
                        JCFG.vit, all_layers=False, fused=True)
    m16 = MaskFormer(TCFG)
    m16.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = vit_apply(m16.to(torch.bfloat16).encoder,
                        torch.from_numpy(x).to(torch.bfloat16), fused=True)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.parametrize("xla_precision,tol,min_corr",
                         [("as_written", 1e-3, 0.999999),
                          ("xla_default", 0.05, 0.9999)])
def test_bf16_fused_forward_matches_sod_tpu(weights, rng, interpret_k1,
                                            xla_precision, tol, min_corr):
    params, model = weights
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    fwd = jax.jit(lambda p, v: maskformer_apply(p, v, JCFG, fused=True))
    opts = ({"xla_allow_excess_precision": False}
            if xla_precision == "as_written" else {})
    ref = fwd.lower(p16, xj).compile(compiler_options=opts)(p16, xj)
    m16 = MaskFormer(TCFG)
    m16.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = m16.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16),
                                     fused=True)
    for k in ("mask_pred", "objectness"):
        assert out[k].dtype == torch.float32
        a, b = _np(out[k]), _np(ref[k])
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > min_corr, k
    np.testing.assert_allclose(_np(out["features"]), _np(ref["features"]),
                               atol=tol if xla_precision == "xla_default" else 0,
                               rtol=2.0 ** -7)
    # the served query: the port's choice is a best query of sod_tpu's up
    # to the tolerance (a near-tie may pick the other one)
    ours, theirs = (_np(o["objectness"])[:, -1, :, 0] for o in (out, ref))
    chosen = theirs[np.arange(len(theirs)), ours.argmax(-1)]
    assert np.all(chosen >= theirs.max(-1) - tol)


def test_bf16_forward_with_f32_params_matches_sod_tpu(weights, rng):
    """Training's mix: f32 master weights, bf16 compute, unfused.  Every
    linear rounds its weight to bf16 first, as ``sod_tpu``'s
    ``w.astype(x.dtype)`` does; with XLA's excess precision off the two
    agree to f32 noise."""
    params, model = weights
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    fwd = jax.jit(lambda p, v: maskformer_apply(p, v, JCFG))
    ref = fwd.lower(params, xj).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, xj)
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(torch.bfloat16))
    for k in ("mask_pred", "objectness"):
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(_np(out["features"]), _np(ref["features"]),
                               atol=0, rtol=2.0 ** -8)


def test_fused_fp32_request_runs_the_unfused_blocks(weights, rng):
    _, model = weights
    x = torch.from_numpy(rng.randn(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(vit_apply(model.encoder, x, fused=True),
                           vit_apply(model.encoder, x, fused=False))


def test_fused_bf16_request_beyond_the_guard_runs_the_gridded_kernels(weights, rng):
    """34 x 34 patches + CLS = 1157 tokens -> n_pad 1280 > 1024: each block
    is K5 (attention half) then K4 (MLP half), sod_tpu's gridded route (on
    the CPU their plain versions; tests/test_torch_evaluator.py holds them
    against the interpreted Pallas kernels)."""
    from sod_tpu_torch.models.vit import LN_EPS, prepare_tokens
    from sod_tpu_torch.ops.fused_attn import fused_ln_attn_infer_reference
    from sod_tpu_torch.ops.fused_mlp import fused_ln_mlp_reference

    _, model = weights
    m16 = MaskFormer(TCFG)
    m16.load_state_dict(model.state_dict())
    enc = m16.to(torch.bfloat16).encoder
    x = torch.from_numpy(rng.randn(1, 272, 272, 3).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = vit_apply(enc, x, fused=True)
        tokens, _ = prepare_tokens(enc, x)
        out = torch.nn.functional.pad(tokens, (0, 0, 0, 1280 - 1157))
        for blk in enc.blocks:
            out = fused_ln_attn_infer_reference(out, blk, 2, 1157, eps=LN_EPS)
            out = fused_ln_mlp_reference(out, blk, eps=LN_EPS)
        ref = enc.norm(out[:, :1157])
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1157, 64)
    assert torch.equal(got, ref)


class _Cfg:
    """The live serving settings of ``sod_tpu.config.Config``."""
    arch, use_binary_classifier, learnable_pixel_decoder = "vit_small", True, False
    quantize, use_fused_eval, use_fused_mlp, use_fused_train = "none", False, False, False
    n_queries, n_decoder_layers, scale_factor, patch_size = 20, 6, 2, 8


def test_config_from_takes_the_live_configuration():
    mcfg = config_from(_Cfg())
    assert (mcfg.n_queries, mcfg.n_decoder_layers, mcfg.scale_factor) == (20, 6, 2)
    assert (mcfg.vit.embed_dim, mcfg.vit.n_heads, mcfg.vit.depth,
            mcfg.vit.patch_size, mcfg.vit.pos_grid) == (384, 6, 12, 8, 28)


@pytest.mark.parametrize("flash", [True, False])
def test_config_from_maps_pallas_attention_onto_use_flash(flash):
    """``use_pallas_attention`` -> ``ViTConfig.use_flash`` -> every block's
    attention through K2 (sod_tpu/models/maskformer.py:94)."""
    cfg = _Cfg()
    cfg.use_pallas_attention = flash
    mcfg = config_from(cfg)
    assert mcfg.vit.use_flash is flash
    model = MaskFormer(mcfg)
    assert all(blk.attn.use_flash is flash for blk in model.encoder.blocks)


@pytest.mark.parametrize("key,value", [
    ("remat", True), ("use_copy_paste", True), ("loss_every_decoder_layer", False),
    ("async_checkpoint", True), ("fsdp", "zero1"), ("mesh_data_axis", 2),
    ("mesh_model_axis", 2), ("mesh_pipe_axis", 2), ("mesh_seq_axis", 2)])
def test_config_from_refuses_settings_it_does_not_port(key, value):
    """Every one is ported, so accepted as ``sod_tpu``'s ``config_from``
    takes it: ``remat`` carried into ``ViTConfig``,
    ``loss_every_decoder_layer`` into ``return_intermediate`` (read by no
    forward), and ``use_copy_paste`` / ``async_checkpoint`` / ``fsdp`` /
    ``mesh_data_axis`` and the model-sharding layouts' ``mesh_model_axis``
    / ``mesh_pipe_axis`` / ``mesh_seq_axis``, read by the dataset and the
    Trainer (``parallel/layouts.py``), leave the model's config as it is."""
    cfg = _Cfg()
    setattr(cfg, key, value)
    mcfg, live = config_from(cfg), config_from(_Cfg())
    carried = {"remat": mcfg.vit.remat,
               "loss_every_decoder_layer": mcfg.return_intermediate}
    if key in carried:
        assert carried[key] == value
        assert mcfg != live
    else:
        assert mcfg == live


@pytest.mark.parametrize("key,field", [
    ("use_fused_mlp", "fused_mlp"), ("use_fused_train", "fused_train"),
    ("fused_save_acts", "fused_save_acts")])
def test_config_from_maps_the_fused_training_switches(key, field):
    """``use_fused_mlp`` / ``use_fused_train`` / ``fused_save_acts`` ->
    ``ViTConfig`` (sod_tpu/models/maskformer.py:96-98); each alone."""
    cfg = _Cfg()
    setattr(cfg, key, True)
    vit = config_from(cfg).vit
    on = {f: getattr(vit, f) for f in ("fused_mlp", "fused_train", "fused_save_acts")}
    assert on == {f: f == field for f in on}
    model = MaskFormer(config_from(cfg))
    assert all(blk.fused_mlp is (field == "fused_mlp") for blk in model.encoder.blocks)


def test_config_from_accepts_use_fused_eval():
    """The Evaluator reads ``use_fused_eval``; the model is the same."""
    cfg = _Cfg()
    cfg.use_fused_eval = True
    assert config_from(cfg) == config_from(_Cfg())


@pytest.mark.parametrize("quantize", ["int8", "none"])
def test_config_from_leaves_quantize_to_the_service(quantize):
    """Only ``SelfMaskInference`` reads ``quantize`` (as in ``sod_tpu``): the
    model, and with it the Trainer and the Evaluator, is the same."""
    cfg = _Cfg()
    cfg.quantize = quantize
    assert config_from(cfg) == config_from(_Cfg())


def test_config_from_refuses_exact_accumulation():
    """Nothing left to refuse: exact accumulation (GradCache) is a setting
    of the train step, so ``config_from`` builds the live model for it, at
    any number of micro-batches."""
    for steps in (1, 2):
        cfg = _Cfg()
        cfg.grad_accum_mode, cfg.grad_accum_steps = "exact", steps
        assert config_from(cfg) == config_from(_Cfg())
