"""DINO-variant ViT encoder of the port (twin of ``sod_tpu/models/vit.py``).

Images are NHWC [B, H, W, 3]; tokens [B, N, D] with CLS at index 0.
Parameter names follow the reference's ``vision_transformer.py`` (DINO
``deit_small``), so a real checkpoint and weights carried over from
``sod_tpu`` load alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sod_tpu_torch.ops.attention import Attention
from sod_tpu_torch.ops.fused_block import fused_vit_block
from sod_tpu_torch.ops.layers import LayerNorm, Linear, linear, mlp_apply
from sod_tpu_torch.ops.resize import interpolate_bicubic


LN_EPS = 1e-6                     # the reference ViT's LayerNorm eps
MLP_RATIO = 4


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    n_heads: int = 6
    pos_grid: int = 28            # the pretrained 224-px pos-embed grid
    use_flash: bool = False       # self-attention through the K2 kernels

    @property
    def n_pos_tokens(self) -> int:
        return self.pos_grid * self.pos_grid + 1


def vit_small(patch_size: int = 8, use_flash: bool = False) -> ViTConfig:
    """deit_small: d 384, 6 heads, 12 blocks."""
    return ViTConfig(patch_size=patch_size, embed_dim=384, n_heads=6,
                     pos_grid=224 // patch_size, use_flash=use_flash)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return mlp_apply([self.fc1, self.fc2], x, activation="gelu")


class Block(nn.Module):
    """Pre-norm encoder block; ``forward`` is the unfused erf-GELU path
    (``_block_apply``), its attention through K2 under ``cfg.use_flash``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, LN_EPS)
        self.attn = Attention(d, cfg.n_heads, use_flash=cfg.use_flash)
        self.norm2 = LayerNorm(d, LN_EPS)
        self.mlp = Mlp(d, MLP_RATIO * d)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Holds the reference's conv weight ``proj.weight`` (D, 3, p, p)."""

    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(dim, 3, patch_size,
                                                    patch_size))
        self.proj.bias = nn.Parameter(torch.empty(dim))


def make_input_divisible(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-pad H and W (bottom, right) to a multiple of the patch size."""
    h, w = x.shape[1], x.shape[2]
    pad_h = (patch_size - h % patch_size) % patch_size
    pad_w = (patch_size - w % patch_size) % patch_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return x


def patchify(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), D] as reshape + one matmul (no
    conv: cuDNN would run an f32 convolution in TF32)."""
    b, h, w, c = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    # conv (D, C, py, px) -> rows flattened (py, px, c)
    wm = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], p * p * c)
    return linear(x, wm, bias)


def interpolate_pos_encoding(pos_embed: torch.Tensor, grid_hw: Tuple[int, int],
                             pos_grid: int) -> torch.Tensor:
    """Bicubic-resize the (G*G+1)-token pos-embed to (gh*gw+1) tokens."""
    gh, gw = grid_hw
    if gh == pos_grid and gw == pos_grid:
        return pos_embed
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    d = pos_embed.shape[-1]
    patch_pe = patch_pe.reshape(1, pos_grid, pos_grid, d).permute(0, 3, 1, 2)
    patch_pe = interpolate_bicubic(patch_pe, gh, gw)
    patch_pe = patch_pe.permute(0, 2, 3, 1).reshape(1, gh * gw, d)
    return torch.cat([cls_pe, patch_pe], dim=1)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.n_pos_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, LN_EPS)


def prepare_tokens(vit: VisionTransformer, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patchify + CLS + interpolated pos-embed: ([B, 1+N, D], grid)."""
    cfg = vit.cfg
    x = make_input_divisible(x, cfg.patch_size)
    gh, gw = x.shape[1] // cfg.patch_size, x.shape[2] // cfg.patch_size
    tokens = patchify(x, vit.patch_embed.proj.weight,
                      vit.patch_embed.proj.bias, cfg.patch_size)
    b, _, d = tokens.shape
    cls = vit.cls_token.to(tokens.dtype).expand(b, 1, d)
    tokens = torch.cat([cls, tokens], dim=1)
    pe = interpolate_pos_encoding(vit.pos_embed, (gh, gw), cfg.pos_grid)
    return tokens + pe.to(tokens.dtype), (gh, gw)


def vit_apply(vit: VisionTransformer, x: torch.Tensor,
              fused: bool = False) -> torch.Tensor:
    """Encoder forward: the final-LayerNormed last-layer tokens [B, 1+N, D].

    :param x: [B, H, W, 3] normalized images.
    :param fused: inference path through the fused block kernel, taken for
        bf16 tokens with n_pad <= 1024 and D <= 512 (``sod_tpu``'s guard,
        ``vit.py:324-325``).  Tokens are padded once to a multiple of 128
        before the layer loop.  A bf16 request beyond the guard is one that
        ``sod_tpu`` sends to its gridded kernels, not yet ported: it raises.
        An f32 request runs the unfused erf-GELU blocks, as in ``sod_tpu``.
    """
    cfg = vit.cfg
    tokens, _ = prepare_tokens(vit, x)
    if fused and tokens.dtype == torch.bfloat16:
        b, n, d = tokens.shape
        n_pad = -(-n // 128) * 128
        if n_pad > 1024 or d > 512:
            raise NotImplementedError(
                f"fused encoder at n_pad={n_pad}, d={d} is the gridded "
                "LN+QKV / attention / MLP pipeline (ROADMAP kernels K5 and "
                "K4), not ported yet")
        out = F.pad(tokens, (0, 0, 0, n_pad - n))
        for blk in vit.blocks:
            out = fused_vit_block(out, blk, cfg.n_heads, n_real=n,
                                  eps=LN_EPS)
        return vit.norm(out[:, :n])
    for blk in vit.blocks:
        tokens = blk(tokens)
    return vit.norm(tokens)
