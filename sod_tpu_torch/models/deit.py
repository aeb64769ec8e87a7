"""Distilled DeiT of the port (twin of ``sod_tpu/models/deit.py``).

The reference's ``DistilledVisionTransformer`` (``networks/timm_deit.py``):
a ViT with a distillation token after CLS, a pos-embed of N + 2 tokens and
two classifier heads whose logits are averaged.  A standalone backbone:
the reference's MaskFormer cannot consume it.  Keys are timm's
(``cls_token``, ``dist_token``, ``pos_embed``, ``blocks.{i}.*``, ``norm``,
``head``, ``head_dist``); images NHWC.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from sod_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    patchify,
    random_vit_state_dict,
)
from sod_tpu_torch.ops.layers import Linear, linear
from sod_tpu_torch.ops.resize import interpolate_bicubic


@dataclass(frozen=True)
class DeiTConfig:
    vit: ViTConfig = field(default_factory=lambda: ViTConfig(
        patch_size=16, embed_dim=384, n_heads=6, pos_grid=14))
    num_classes: int = 1000


def deit_small_distilled_patch16_224() -> DeiTConfig:
    return DeiTConfig()


class DistilledVisionTransformer(VisionTransformer):
    def __init__(self, cfg: DeiTConfig):
        super().__init__(cfg.vit)
        self.deit_cfg = cfg
        d = cfg.vit.embed_dim
        self.dist_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.vit.pos_grid ** 2 + 2, d))
        if cfg.num_classes > 0:
            self.head = Linear(d, cfg.num_classes)
            self.head_dist = Linear(d, cfg.num_classes)


def deit_init(cfg: DeiTConfig, seed: int = 0) -> DistilledVisionTransformer:
    """A DeiT with seeded random weights (``random_vit_state_dict``)."""
    model = DistilledVisionTransformer(cfg)
    model.load_state_dict(random_vit_state_dict(model, seed))
    return model


def deit_forward_features(model: DistilledVisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, 2 + N, D] final-norm tokens (CLS, dist, patches);
    the patch pos-embed is resized bicubically for another grid."""
    vcfg = model.cfg
    tokens = patchify(x, model.patch_embed.proj.weight, model.patch_embed.proj.bias,
                      vcfg.patch_size)
    b, _, d = tokens.shape
    cls = model.cls_token.to(tokens.dtype).expand(b, 1, d)
    dist = model.dist_token.to(tokens.dtype).expand(b, 1, d)
    tokens = torch.cat([cls, dist, tokens], dim=1)
    pe = model.pos_embed
    gh, gw = x.shape[1] // vcfg.patch_size, x.shape[2] // vcfg.patch_size
    if (gh, gw) != (vcfg.pos_grid, vcfg.pos_grid):
        patch_pe = pe[:, 2:].reshape(1, vcfg.pos_grid, vcfg.pos_grid, d).permute(0, 3, 1, 2)
        patch_pe = interpolate_bicubic(patch_pe, gh, gw).permute(0, 2, 3, 1)
        pe = torch.cat([pe[:, :2], patch_pe.reshape(1, gh * gw, d)], dim=1)
    tokens = tokens + pe.to(tokens.dtype)
    for blk in model.blocks:
        tokens = blk(tokens)
    return model.norm(tokens)


def deit_apply(model: DistilledVisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """Classification: the mean of the CLS and distillation heads' logits."""
    tokens = deit_forward_features(model, x)
    logits = linear(tokens[:, 0], model.head.weight, model.head.bias)
    logits_d = linear(tokens[:, 1], model.head_dist.weight, model.head_dist.bias)
    return (logits + logits_d) / 2.0
