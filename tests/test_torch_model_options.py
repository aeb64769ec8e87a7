"""The model options off the live config, each against its ``sod_tpu`` twin
on the same weights (a sod_tpu tree drawn with numpy, carried over by
``state_dict_from_jax``) and the same numpy inputs, at a small size: ViT d
64, 2 heads, depth 2; 2 decoder layers; 4 queries.  The ResNet-50
MaskFormer's forward and train step are in
tests/test_torch_resnet_maskformer.py.

* the non-bc head, f32: <= 1e-4, no ``objectness`` key; its canvas branch
  (which contracts the queries, not ``ffn(queries)``) <= 1e-4.
* one f32 train step of the non-bc head against ``make_train_step`` (the
  objectness-less loss: the contrastive term alone), as the f32 ViT step
  of tests/test_torch_train_step.py; ``linear_classifier`` and ``norm``
  move by weight decay alone.
* the pixel-decoder and encoder helpers and the DINO head, f32 <= 1e-5
  (probabilities and normalised outputs) or 1e-4.
* the seeded ``*_init`` functions: keys and shapes of every model, bounds
  and moments of each distribution, the same tensors for the same seed; and
  ``random_state_dict`` of the live config bit for bit what it was.
"""
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.config import Config
from sod_tpu.models import maskformer as jmf
from sod_tpu.models import vit as jvit
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.train.optim import build_optimizer as jax_build_optimizer
from sod_tpu.train.step import make_train_step as jax_make_train_step
from sod_tpu_torch.models import maskformer as tmf
from sod_tpu_torch.models import resnet as tr
from sod_tpu_torch.models import vit as tvit
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops import layers as tlayers
from sod_tpu_torch.ops.attention import mha_init
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
SMALL = dict(n_queries=4, n_decoder_layers=2)
NO_EXCESS = {"xla_allow_excess_precision": False}


def _jcfg(**kw):
    return JaxMaskFormerConfig(**SMALL, vit=JaxViTConfig(**VIT), **kw)


def _tcfg(**kw):
    return MaskFormerConfig(**SMALL, vit=ViTConfig(**VIT), **kw)


def _port(params, tcfg):
    model = MaskFormer(tcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(jax.tree.map(np.asarray, params)).items()})
    return model


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _jax_tree(jcfg, seed):
    """A sod_tpu MaskFormer tree of ``jcfg``'s shapes drawn with numpy
    (``jax.random``'s ResNet-50 init takes seconds to compile): He-normal
    convolutions, linears U(+-1/sqrt(fan_in)), norms' scales and BN
    variances U(0.8, 1.2), their biases and BN means N(0, 0.05), queries
    N(0, 1), CLS and pos-embed N(0, 0.02)."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jmf.maskformer_init, cfg=jcfg),
                            jax.random.key(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if len(shape) == 4:
            a = r.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        elif name in ("scale", "var"):
            a = r.uniform(0.8, 1.2, shape)
        elif name in ("bias", "mean"):
            a = r.normal(0.0, 0.05, shape)
        elif name == "w":
            a = r.uniform(-1.0, 1.0, shape) / np.sqrt(shape[-2])
        elif name == "b":
            a = r.uniform(-0.05, 0.05, shape)
        elif name == "query_embed":
            a = r.standard_normal(shape)
        else:
            a = r.normal(0.0, 0.02, shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def non_bc():
    jcfg = _jcfg(use_binary_classifier=False)
    params = _jax_tree(jcfg, 1)
    return jcfg, params, _port(params, _tcfg(use_binary_classifier=False))


# ---------------------------------------------------------------- non-bc head
def test_non_bc_forward_matches_sod_tpu(non_bc):
    jcfg, params, model = non_bc
    assert isinstance(model.ffn.layers[-1], tlayers.Linear)
    assert model.ffn.layers[-1].weight.shape == (64, 64)
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jmf.maskformer_apply(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert set(out) == set(ref) == {"mask_pred", "features"}
    for k in out:
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), atol=1e-4, rtol=0, err_msg=k)


def test_non_bc_canvas_forward_contracts_the_queries(non_bc):
    jcfg, params, model = non_bc
    from sod_tpu_torch.train.evaluator import canvas_inputs

    r = np.random.default_rng(4)
    u8 = r.integers(0, 256, (2, 32, 40, 3), dtype=np.uint8)
    grids = np.array([[4, 5], [3, 2]], np.int32)
    with torch.no_grad():
        x, token_mask, pe = canvas_inputs(model, torch.from_numpy(u8),
                                          torch.from_numpy(grids), torch.float32)
    ref = jmf.maskformer_apply_canvas(params, jnp.asarray(x.numpy()), jcfg,
                                      jnp.asarray(token_mask.numpy()), jnp.asarray(pe.numpy()),
                                      jnp.asarray(grids))
    with torch.no_grad():
        out = tmf.maskformer_apply_canvas(model, x, token_mask, pe, torch.from_numpy(grids))
    assert set(out) == set(ref) == {"mask_pred", "features"}
    for k in out:
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), atol=1e-4, rtol=0, err_msg=k)


# ----------------------------------------------------------------- train steps
def _batch(seed, b):
    r = np.random.default_rng(seed)
    gt = np.zeros((b, 2, 32, 32), np.uint8)
    valid = np.zeros((b, 2), bool)
    for i in range(b):
        y, x = r.integers(0, 14, 2)
        gt[i, 0, y:y + 12, x:x + 14] = 1
        valid[i, 0] = True
    return {"image": r.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
            "gt_masks": gt, "gt_valid": valid,
            "labels": np.array([5, 5, 9, 9][:b], np.int32)}


def _steps(jcfg, params, model, cfg, batch):
    """One step each way from the same weights: (sod_tpu's metrics, the
    port's, sod_tpu's params after, the port's state dict before and
    after)."""
    tx = jax_build_optimizer(cfg, 2)
    jstep = jax_make_train_step(cfg, tx, jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, _, jm = jstep(params, tx.init(params), jb)
    opt = build_optimizer(cfg, model.parameters(), 2)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tm = make_train_step(cfg, model, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return ({k: float(jm[k]) for k in METRIC_KEYS}, {k: float(tm[k]) for k in METRIC_KEYS},
            state_dict_from_jax(jax.tree.map(np.asarray, new)), before, after)


def test_non_bc_train_step_matches_sod_tpu(non_bc):
    """The objectness-less loss (the contrastive term alone) in both; no
    gradient reaches ``linear_classifier`` and ``norm``, which move by
    AdamW's weight decay alone: p (1 - lr wd)."""
    jcfg, params, _ = non_bc
    model = _port(params, _tcfg(use_binary_classifier=False))
    cfg = Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                 compute_dtype="float32", use_binary_classifier=False, weight_decay=0.05)
    jm, tm, jnew, before, after = _steps(jcfg, params, model, cfg, _batch(7, 4))
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("dice_loss", "ranking_loss", "classification_loss"):
        assert tm[k] == jm[k] == 0.0, k
    assert tm["contrastive_loss"] > 0
    for k in after:
        np.testing.assert_allclose(after[k].numpy() - before[k].numpy(),
                                   jnew[k] - before[k].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=k)
    decay = 1.0 - 1e-3 * 0.05
    for k in ("linear_classifier.weight", "linear_classifier.bias", "norm.weight",
              "norm.bias"):
        np.testing.assert_allclose(after[k].numpy(), before[k].numpy() * decay,
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert not torch.equal(after["linear_classifier.weight"],
                           before["linear_classifier.weight"])


# -------------------------------------------------------------------- helpers
def test_pixel_decoder_helpers_match_sod_tpu():
    np.testing.assert_allclose(tmf.positional_encoding_2d(16, 5, 7).numpy(),
                               np.asarray(jmf.positional_encoding_2d(16, 5, 7)),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tmf.positional_encoding_2d(6, 2, 2)
    r = np.random.default_rng(8)
    mask = r.random((2, 5, 6)) > 0.3
    for kw in ({}, {"normalize": True}, {"normalize": True, "scale": 3.0}):
        np.testing.assert_allclose(
            tmf.position_embedding_sine((2, 5, 6), 8, not_mask=torch.from_numpy(mask),
                                        **kw).numpy(),
            np.asarray(jmf.position_embedding_sine((2, 5, 6), 8,
                                                   not_mask=jnp.asarray(mask, jnp.float32),
                                                   **kw)), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tmf.position_embedding_sine((1, 2, 2), scale=1.0)
    jp = jmf.upsample_block_init(jax.random.key(2), 8, 16, n_groups=4)
    tp = {"conv": torch.from_numpy(np.asarray(jp["conv"]).transpose(3, 2, 0, 1).copy()),
          "conv_b": torch.from_numpy(np.asarray(jp["conv_b"])),
          "gn_scale": torch.from_numpy(np.asarray(jp["gn_scale"])),
          "gn_bias": torch.from_numpy(np.asarray(jp["gn_bias"])), "n_groups": 4}
    x = r.standard_normal((2, 5, 6, 8)).astype(np.float32)
    out = tmf.upsample_block_apply(tp, torch.from_numpy(x))
    assert out.shape == (2, 10, 12, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jmf.upsample_block_apply(
        jp, jnp.asarray(x))), atol=1e-5, rtol=0)
    init = tmf.upsample_block_init(torch.Generator().manual_seed(0), 8, 16, n_groups=4)
    assert {k: tuple(v.shape) for k, v in init.items() if k != "n_groups"} == {
        "conv": (16, 8, 3, 3), "conv_b": (16,), "gn_scale": (16,), "gn_bias": (16,)}
    assert init["conv"].abs().max() <= 1 / np.sqrt(72)


@pytest.fixture(scope="module")
def vit_pair():
    jcfg = JaxViTConfig(**VIT)
    params = _jax_tree(_jcfg(), 3)["encoder"]
    vit = tvit.VisionTransformer(ViTConfig(**VIT))
    from sod_tpu_torch.models.convert import vit_state_dict_from_jax

    vit.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in vit_state_dict_from_jax(params).items()})
    x = np.random.default_rng(9).standard_normal((2, 24, 32, 3)).astype(np.float32)
    return jcfg, params, vit, x


@pytest.mark.parametrize("name,kw", [
    ("vit_last_selfattention", {}), ("vit_selfattention", {}),
    ("vit_selfattention", {"all_blocks": True}),
    ("vit_get_tokens", {}), ("vit_get_tokens", {"norm": False, "patch_tokens": True}),
    ("vit_get_tokens", {"layers": [1], "patch_tokens": True}),
    ("vit_n_last_cls", {"n": 2, "return_patch_avgpool": True}),
    ("vit_n_last_patch_emb", {"n": 2})])
def test_encoder_helpers_match_sod_tpu(vit_pair, name, kw):
    jcfg, params, vit, x = vit_pair
    ref = getattr(jvit, name)(params, jnp.asarray(x), jcfg, **kw)
    with torch.no_grad():
        out = getattr(tvit, name)(vit, torch.from_numpy(x), **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5 if "attention" in name else 1e-4,
                               rtol=0)


def test_helpers_with_flash_take_k2_and_the_probabilities_the_plain_softmax(vit_pair):
    """Under ``use_flash`` the token helpers go through K2 (its plain version
    on the CPU; counted by the wrapper only on the card) and give the same
    tokens; the probability helpers ignore it."""
    _, params, vit, x = vit_pair
    flash = tvit.VisionTransformer(tvit.ViTConfig(**VIT, use_flash=True))
    flash.load_state_dict(vit.state_dict())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for name in ("vit_n_last_cls", "vit_selfattention"):
            np.testing.assert_allclose(_np(getattr(tvit, name)(flash, xt)),
                                       _np(getattr(tvit, name)(vit, xt)), atol=1e-5)


def test_dino_head_matches_sod_tpu():
    r = np.random.default_rng(10)
    jp = jvit.dino_head_init(jax.random.key(4), 32, 40, nlayers=3, hidden_dim=48,
                             bottleneck_dim=16)
    tp = {"mlp": [{"weight": torch.from_numpy(np.asarray(jp["mlp"][f"fc{i}"]["w"]).T.copy()),
                   "bias": torch.from_numpy(np.asarray(jp["mlp"][f"fc{i}"]["b"]))}
                  for i in range(3)],
          "last_v": torch.from_numpy(np.asarray(jp["last_v"]).T.copy()),
          "last_g": torch.from_numpy(np.asarray(jp["last_g"]))}
    x = r.standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_allclose(tvit.dino_head_apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jvit.dino_head_apply(jp, jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    for nlayers, dims in ((1, [(16, 32)]), (3, [(48, 32), (48, 48), (16, 48)])):
        init = tvit.dino_head_init(torch.Generator().manual_seed(0), 32, 40, nlayers=nlayers,
                                   hidden_dim=48, bottleneck_dim=16)
        assert [tuple(m["weight"].shape) for m in init["mlp"]] == dims
        assert init["last_v"].shape == (40, 16) and torch.equal(init["last_g"], torch.ones(40))


# ----------------------------------------------------------------- init functions
@pytest.mark.parametrize("arch,bc", [("vit_small", True), ("vit_small", False),
                                     ("resnet50", True), ("resnet50", False)])
def test_maskformer_init_fills_every_key_like_sod_tpus(arch, bc):
    """Keys and shapes of the port's model, of ``maskformer_init`` and of
    sod_tpu's tree carried over are one set; the same seed gives the same
    tensors, another seed others; the model loads the result."""
    tcfg = _tcfg(arch=arch, use_binary_classifier=bc)
    model = MaskFormer(tcfg)
    sd = tmf.maskformer_init(torch.Generator().manual_seed(0), tcfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    jshape = jax.eval_shape(functools.partial(jmf.maskformer_init, cfg=_jcfg(
        arch=arch, use_binary_classifier=bc)), jax.random.key(0))
    carried = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshape))
    assert {k: tuple(v.shape) for k, v in carried.items()} == want
    again = tmf.maskformer_init(torch.Generator().manual_seed(0), tcfg)
    other = tmf.maskformer_init(torch.Generator().manual_seed(1), tcfg)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["query_embed"], other["query_embed"])
    model.load_state_dict(sd)


def test_init_functions_draw_sod_tpus_distributions():
    g = torch.Generator().manual_seed(0)
    t = tlayers.trunc_normal(g, (200, 300))
    assert abs(float(t.std()) - 0.02) < 5e-4 and abs(float(t.mean())) < 5e-4
    assert float(t.abs().max()) <= 2.0
    wide = tlayers.trunc_normal(g, (20000,), std=1.0, a=-1.5, b=1.5)
    assert float(wide.min()) >= -1.5 and float(wide.max()) <= 1.5
    assert float(wide.min()) < -1.45 and float(wide.max()) > 1.45
    lin = tlayers.linear_init(g, 400, 30, init="torch_default")
    for v in lin.values():
        assert float(v.abs().max()) <= 1 / 20 and float(v.abs().max()) > 0.9 / 20
    tn = tlayers.linear_init(g, 400, 30)
    assert torch.equal(tn["bias"], torch.zeros(30)) and tn["weight"].shape == (30, 400)
    mlp = tlayers.mlp_init(g, [8, 16, 4])
    assert [tuple(m["weight"].shape) for m in mlp] == [(16, 8), (4, 16)]
    with pytest.raises(ValueError):
        tlayers.linear_init(g, 2, 2, init="xavier")
    mha = mha_init(g, 64)
    assert mha["in_proj_weight"].shape == (192, 64)
    assert float(mha["in_proj_weight"].abs().max()) <= np.sqrt(6 / 256)
    assert float(mha["out_proj.weight"].abs().max()) <= 1 / 8
    assert not mha["in_proj_bias"].any() and not mha["out_proj.bias"].any()
    conv = tr.conv_init(g, 3, 3, 64, 128)
    assert conv.shape == (128, 64, 3, 3)
    assert abs(float(conv.std()) - np.sqrt(2 / (9 * 128))) < 2e-3
    bn = tr.bn_init(7)
    assert [float(bn[k].sum()) for k in ("weight", "bias", "running_mean", "running_var")] \
        == [7.0, 0.0, 0.0, 7.0]
    vit = tvit.vit_init(g, ViTConfig(**VIT))
    assert not vit["cls_token"].any() and float(vit["pos_embed"].std()) < 0.03
    assert float(vit["patch_embed.proj.weight"].abs().max()) <= 1 / np.sqrt(192)
    assert not vit["blocks.0.attn.qkv.bias"].any()
    assert torch.equal(vit["norm.weight"], torch.ones(64))


# sha256 over (key, f32 bytes) of random_state_dict(MaskFormer(cfg), 0) before
# the ResNet and non-bc keys existed: the live config at full size, and the
# small ViT config of the tests
LIVE_HASHES = {"full": "8a9b4ae98e11899a9efc3d8a3df2812c13c87a6e35d3198dcde6dc2b05c279b9",
               "small": "f69a130ef9f0dcfc44f2c9f0a9e68ddad76510e2316effb6e05c02026f1ab238"}


@pytest.mark.parametrize("size", ["full", "small"])
def test_random_state_dict_of_the_live_config_is_unchanged(size):
    cfg = MaskFormerConfig() if size == "full" else _tcfg()
    h = hashlib.sha256()
    for k, v in tmf.random_state_dict(MaskFormer(cfg), 0).items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == LIVE_HASHES[size]


def test_random_state_dict_draws_the_resnet_and_non_bc_keys():
    model = MaskFormer(_tcfg(arch="resnet50", use_binary_classifier=False))
    sd = tmf.random_state_dict(model, 0)
    model.load_state_dict(sd)
    w = sd["encoder.layer2.0.conv2.weight"]
    assert abs(float(w.std()) - np.sqrt(2 / (9 * 128))) < 2e-3
    assert torch.equal(sd["encoder.bn1.running_var"], torch.ones(64))
    assert not sd["encoder.layer1.0.downsample.1.running_mean"].any()
    assert float(sd["linear_layer.weight"].abs().max()) <= 1 / np.sqrt(2048)
    assert float(sd["linear_classifier.weight"].abs().max()) <= 1 / np.sqrt(384)
    assert torch.equal(sd["norm.weight"], torch.ones(384))
