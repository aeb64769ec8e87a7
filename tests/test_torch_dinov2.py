"""SelfMask on DINOv2's ViT-g/14 with registers (``arch="dinov2_vitg14_reg"``)
against the benchmark's plain reference (``sodbench/reference/dinov2.py``),
on the CPU at a tiny size of the same shape: d 128, 2 heads of 64, 2
blocks, patch 14, 4 registers, the SwiGLU hidden from DINOv2's formula
(344), a 4 x 4 position grid (56 px), the LayerScale gammas drawn away from
1.  One set of seeded weights goes to both.  Compared: the encoder's tokens
at the native grid and at two others (the antialiased bicubic resize up
and down), ``MaskFormer``'s outputs, one training step's loss and every
leaf's gradient, ``remat``; that the registers never reach the decoder;
that the fused and int8 flags raise; the hub's key layout
(``convert.convert_dinov2``) and ``get_model``.

Both sides run f32 here.  The port's patch embedding is a product of
reshaped patches where the reference convolves, and its sums run in
another order, so the two differ by f32 rounding only: a few ulps of each
value, grown through two blocks and the decoder to at most ~1e-5 of the
outputs' scale."""
import math

import numpy as np
import pytest
import torch

from sod_tpu_torch.config import Config
from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.models import convert
from sod_tpu_torch.models import maskformer as MF
from sod_tpu_torch.models import vit as V
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import make_train_step
from sodbench import inputs
from sodbench.reference import dinov2 as R
from sodbench.reference.model import Arith, make_weights

ARCH = "dinov2_vitg14_reg"
TINY = {"d": 128, "depth": 2, "patch": 14, "pos_grid": 4, "n_registers": 4}
# f32 on both sides, sums in another order (module docstring): the tokens
# are LayerNorm outputs of unit scale, the masks and objectness sigmoids
TOKENS_ATOL = 2e-5
OUT_ATOL = 2e-5
# a leaf's gradient norm relative to the largest of its own and the median
# leaf's (the benchmark's measure): f32 sums in another order through the
# backward, far below the bf16 program's 1e-2 on the card
GRAD_RTOL = 1e-4


def _vit_cfg(**kw) -> V.ViTConfig:
    return V.ViTConfig(patch_size=14, embed_dim=128, depth=2, n_heads=2, pos_grid=4,
                       dinov2=True, **kw)


def _weights(seed: int = 5):
    """The reference's seeded weights at the tiny size, the gammas redrawn
    in [0.5, 1.5] (a gamma of 1 would hide a missing LayerScale)."""
    w = make_weights(R.param_specs(**TINY), inputs.generator(seed, 0, "cpu"), "cpu")
    g = torch.Generator().manual_seed(seed)
    for k in w:
        if k.endswith(".gamma"):
            w[k] = 0.5 + torch.rand(w[k].shape, generator=g)
    return w


def _model(w, **kw) -> MF.MaskFormer:
    m = MF.MaskFormer(MF.MaskFormerConfig(arch=ARCH, vit=_vit_cfg(**kw)))
    m.load_state_dict(w)
    return m


def _images(side: int, b: int = 2, seed: int = 3):
    return inputs.images(inputs.generator(seed, 0, "cpu"), b, side, side, "cpu")


def test_tiny_model_has_the_hub_shape():
    cfg = _vit_cfg()
    assert cfg.ffn_hidden == 344 == (int(4 * 128 * 2 / 3) + 7) // 8 * 8
    assert R.swiglu_hidden(1536) == V.dinov2_vitg14_reg().ffn_hidden == 4096
    w = _weights()
    sd = _model(w).state_dict()
    assert cfg.n_registers == 4
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in w.items()}
    blk = [k[len("encoder.blocks.0."):] for k in sd if k.startswith("encoder.blocks.0.")]
    assert blk == ["norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                   "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "norm2.weight",
                   "norm2.bias", "mlp.w12.weight", "mlp.w12.bias", "mlp.w3.weight",
                   "mlp.w3.bias", "ls2.gamma"]
    assert sd["linear_layer.weight"].shape == (384, 128)


@pytest.mark.parametrize("side", [56, 70, 42])
def test_encoder_tokens_equal_the_reference(side):
    """56 px is the table's own 4 x 4 grid; 70 and 42 px resize it (5 x 5,
    3 x 3) bicubic with antialiasing.  Tokens: CLS, 4 registers, patches."""
    w = _weights()
    m = _model(w)
    u8 = _images(side)
    with torch.no_grad():
        got = V.vit_apply(m.encoder, normalize_device(u8))
        want, grid = R.encoder_forward(w, Arith(), R.normalize(u8))
    g = side // 14
    assert grid == (g, g) and got.shape == want.shape == (2, 1 + 4 + g * g, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOKENS_ATOL)


def test_pos_embed_resize_is_antialiased_bicubic():
    """The port's table at another grid is ``F.interpolate(...,
    antialias=True)``'s (DINOv2's kernel, a = -0.5), not the ViT-S bicubic."""
    pe = torch.randn(1, 17, 8)
    aa = V.interpolate_pos_encoding(pe, (3, 3), 4, antialias=True)
    plain = V.interpolate_pos_encoding(pe, (3, 3), 4)
    ref = R.pos_embed_for({"encoder.pos_embed": pe}, 3, 3)
    torch.testing.assert_close(aa, ref, rtol=0, atol=1e-6)
    assert float((aa - plain).abs().max()) > 1e-3
    assert V.interpolate_pos_encoding(pe, (4, 4), 4, antialias=True) is pe


@pytest.mark.parametrize("side", [56, 70])
def test_maskformer_outputs_equal_the_reference(side):
    w = _weights()
    m = _model(w)
    u8 = _images(side)
    with torch.no_grad():
        got = m(normalize_device(u8))
        want = R.forward(w, u8)
    for k in ("mask_pred", "objectness", "features"):
        np.testing.assert_allclose(got[k].reshape(want[k].shape).numpy(), want[k].numpy(),
                                   rtol=0, atol=OUT_ATOL, err_msg=k)


def _batch(side: int = 56, b: int = 4, seed: int = 3):
    g = inputs.generator(seed, 0, "cpu")
    masks, valid = inputs.ellipse_masks(g, b, 4, side, side, (1, 3), "cpu")
    return {"image": inputs.images(g, b, side, side, "cpu"), "gt_masks": masks,
            "gt_valid": valid, "labels": torch.tensor([0, 0, 1, 1][:b], dtype=torch.int32)}


def _one_step(w, remat: bool = False):
    """The port's train step (f32) from ``w``: the loss and the first
    gradient per leaf as AdamW got it (its first moment over 1 - b1)."""
    cfg = Config(arch=ARCH, patch_size=14, compute_dtype="float32", batch_size=4,
                 lr=1e-3, lr_warmup_duration=0, n_epochs=2, remat=remat)
    m = _model(w, remat=remat)
    opt = build_optimizer(cfg, m.parameters(), 2)
    out = make_train_step(cfg, m, opt)(_batch())
    names = [n for n, _ in m.named_parameters()]
    return cfg, float(out["loss"]), {n: mu / (1 - opt.b1) for n, mu in zip(names, opt.mu)}


def _leaf_gaps(got, want):
    med = float(np.median([float(g.norm()) for g in want.values()]))
    return {k: float((got[k] - want[k]).norm()) / max(float(want[k].norm()), med) for k in want}


def test_train_step_loss_and_every_gradient_equal_the_reference():
    """One step from weights whose objectness head is constant (its last
    weight zero): the ranking loss sorts each layer's queries by their dice,
    which the program takes on the masks contracted down and the reference
    on the predictions upsampled; queries whose masks saturate to ones tie
    there, take either order by a last-bit rounding, and the order picks the
    objectness differences the gradient flows through.  With every
    objectness equal, each pair's hinge sits at 0 on both sides and no order
    matters; every other term is compared as it is."""
    w = _weights()
    w["ffn.layers.2.weight"].zero_()
    cfg, loss, grads = _one_step(w)
    ref = R.train_steps(w, [_batch()], {"weight_decay": cfg.weight_decay, "lr": cfg.lr,
                                         "weight_contrastive_loss": cfg.weight_contrastive_loss,
                                         "temperature": cfg.temperature}, 2)
    assert math.isclose(loss, ref["losses"][0], rel_tol=1e-5)
    assert set(grads) == set(ref["first_grad"])
    gaps = _leaf_gaps(grads, ref["first_grad"])
    assert max(gaps.values()) <= GRAD_RTOL, max(gaps.items(), key=lambda kv: kv[1])
    # every leaf moves: the registers, CLS and each gamma have a gradient
    for k in ("encoder.register_tokens", "encoder.cls_token", "encoder.blocks.1.ls2.gamma"):
        assert float(ref["first_grad"][k].norm()) > 0


def test_remat_gives_the_same_step():
    """Each block recomputed in the backward (``torch.utils.checkpoint``):
    the same loss and gradients bit for bit."""
    w = _weights()
    _, loss, grads = _one_step(w)
    _, loss_r, grads_r = _one_step(w, remat=True)
    assert loss == loss_r
    assert all(torch.equal(grads[k], grads_r[k]) for k in grads)


def test_registers_never_reach_the_decoder(monkeypatch):
    """The decoder's memory is the adapter over the patch tokens alone:
    [B, gh gw, 384], equal to ``linear_layer(tokens[:, 5:])``."""
    w = _weights()
    m = _model(w)
    seen = []
    real = MF.forward_transformer_decoder
    monkeypatch.setattr(MF, "forward_transformer_decoder",
                        lambda model, memory, **kw: seen.append(memory) or real(model, memory,
                                                                                **kw))
    x = normalize_device(_images(70))
    with torch.no_grad():
        m(x)
        tokens = V.vit_apply(m.encoder, x)
        want = m.linear_layer(tokens[:, 5:])
        patches = m(x, encoder_only=True)["patch_tokens"]
    assert seen[0].shape == (2, 25, 384) and torch.equal(seen[0], want)
    assert patches.shape == (2, 5, 5, 384)


@pytest.mark.parametrize("flag", [{"use_fused_mlp": True}, {"use_fused_train": True},
                                  {"fused_save_acts": True}, {"use_fused_eval": True},
                                  {"quantize": "int8"}])
def test_fused_and_int8_flags_raise(flag):
    with pytest.raises(ValueError, match=ARCH):
        MF.config_from(Config(arch=ARCH, patch_size=14, **flag))


def test_fused_forward_and_other_patches_raise():
    m = _model(_weights())
    with pytest.raises(ValueError, match=ARCH):
        m(normalize_device(_images(56)).to(torch.bfloat16), fused=True)
    with pytest.raises(ValueError, match=ARCH):
        MF.config_from(Config(arch=ARCH, patch_size=16))
    full = MF.config_from(Config(arch=ARCH, patch_size=14))
    assert (full.vit.embed_dim, full.vit.depth, full.vit.n_heads, full.vit.n_registers,
            full.vit.pos_grid, full.embed_dim, full.n_heads) == (1536, 40, 24, 4, 37, 384, 6)


def _hub_state_dict(cfg: V.ViTConfig, device="cpu"):
    """A state dict under the DINOv2 hub's names and shapes (``vit_giant2``,
    ``block_chunks=0``), mask_token included."""
    d, h, g = cfg.embed_dim, cfg.ffn_hidden, cfg.pos_grid
    p = cfg.patch_size
    shapes = {"cls_token": (1, 1, d), "pos_embed": (1, g * g + 1, d),
              "register_tokens": (1, cfg.n_registers, d), "mask_token": (1, d),
              "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        shapes.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                       b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                       b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                       b + "ls1.gamma": (d,), b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                       b + "mlp.w12.weight": (2 * h, d), b + "mlp.w12.bias": (2 * h,),
                       b + "mlp.w3.weight": (d, h), b + "mlp.w3.bias": (d,),
                       b + "ls2.gamma": (d,)})
    shapes.update({"norm.weight": (d,), "norm.bias": (d,)})
    return {k: torch.randn(s, device=device) for k, s in shapes.items()}


def test_hub_layout_converts_to_the_port_at_the_published_shapes():
    """ViT-g/14-reg's 1.15B-parameter layout on the meta device: every hub
    key but ``mask_token`` lands on a port key of the same shape."""
    cfg = V.dinov2_vitg14_reg()
    hub = _hub_state_dict(cfg, "meta")
    with torch.device("meta"):
        port = V.VisionTransformer(cfg).state_dict()
    got = convert.convert_dinov2(hub, depth=cfg.depth)
    assert list(got) == list(port)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in port.items()}
    assert set(hub) - set(got) == {"mask_token"}
    # by hand: patch embedding 904,704; CLS 1,536; table 1370 x 1536; registers
    # 6,144; a block 28,336,640 (qkv 7,082,496, proj 2,360,832, w12
    # 12,591,104, w3 6,292,992, norms 6,144, gammas 3,072); the final norm 3,072
    blocks = 40 * (7_082_496 + 2_360_832 + 12_591_104 + 6_292_992 + 6_144 + 3_072)
    assert sum(v.numel() for v in port.values()) == (904_704 + 1_536 + 1370 * 1536 + 6_144
                                                     + blocks + 3_072) == 1_136_485_376
    del hub["blocks.39.ls2.gamma"]
    with pytest.raises(KeyError):
        convert.convert_dinov2(hub, depth=cfg.depth)


def test_maskformer_init_draws_every_tensor():
    """``maskformer_init`` (a ``torch.Generator``'s draws) fills the DINOv2
    model: DINOv2's init for CLS and registers, gammas 1, SwiGLU linears."""
    cfg = MF.MaskFormerConfig(arch=ARCH, vit=_vit_cfg())
    sd = MF.maskformer_init(torch.Generator().manual_seed(0), cfg)
    m = MF.MaskFormer(cfg)
    m.load_state_dict(sd)
    assert float(sd["encoder.register_tokens"].abs().max()) < 1e-4
    assert sd["encoder.blocks.1.ls2.gamma"].eq(1).all()
    assert float(sd["encoder.blocks.0.mlp.w12.weight"].std()) == pytest.approx(0.02, rel=0.1)


def test_random_state_dict_draws_the_encoder_as_the_bare_vit():
    """``random_state_dict`` fills every tensor of the DINOv2 model and
    draws its encoder as ``random_vit_state_dict`` draws the bare ViT: CLS
    and registers N(0, 1e-6), gammas 1, block linears N(0, 0.02)."""
    m = MF.MaskFormer(MF.MaskFormerConfig(arch=ARCH, vit=_vit_cfg()))
    sd = MF.random_state_dict(m, 7)
    assert list(sd) == list(m.state_dict())
    m.load_state_dict(sd)
    enc = V.random_vit_state_dict(m.encoder, 7)
    assert all(torch.equal(sd[f"encoder.{k}"], v) for k, v in enc.items())
    assert float(sd["encoder.register_tokens"].abs().max()) < 1e-4
    assert sd["encoder.blocks.1.ls1.gamma"].eq(1).all()
    assert float(sd["encoder.blocks.0.mlp.w3.weight"].std()) == pytest.approx(0.02, rel=0.1)
    assert sd["linear_layer.weight"].shape == (384, 128)


def test_get_model_builds_the_arch(monkeypatch, tmp_path):
    """``get_model("maskformer")`` with the arch in the flat config, and the
    bare backbone from a hub-layout checkpoint (nothing downloaded), at the
    tiny size (the published size's draws would take the CPU minutes)."""
    from sod_tpu_torch.models import factory

    tiny = lambda patch_size=14, use_flash=False, remat=False: _vit_cfg(  # noqa: E731
        use_flash=use_flash, remat=remat)
    monkeypatch.setattr(MF, "dinov2_vitg14_reg", tiny)
    monkeypatch.setattr(V, "dinov2_vitg14_reg", tiny)
    mcfg, model, apply_fn = factory.get_model("maskformer", configs=Config(arch=ARCH,
                                                                           patch_size=14))
    assert mcfg.arch == ARCH and isinstance(model, MF.MaskFormer)
    assert model.state_dict()["encoder.blocks.0.ls1.gamma"].eq(1).all()
    out = apply_fn(model, normalize_device(_images(56)))
    assert out["mask_pred"].shape == (2, 6, 20, 8, 8)
    hub = _hub_state_dict(_vit_cfg())
    path = str(tmp_path / "dinov2_vitg14_reg4_pretrain.pth")
    torch.save(hub, path)
    vcfg, vit, fn = factory.get_model(ARCH, checkpoint=path)
    assert vcfg.n_registers == 4 and fn is V.vit_apply
    assert torch.equal(vit.state_dict()["blocks.1.mlp.w12.weight"], hub["blocks.1.mlp.w12.weight"])
