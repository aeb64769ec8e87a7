"""DINO-variant ViT encoder of the port (twin of ``sod_tpu/models/vit.py``).

Images are NHWC [B, H, W, 3]; tokens [B, N, D] with CLS at index 0.
Parameter names follow the reference's ``vision_transformer.py`` (DINO
``deit_small``), so a real checkpoint and weights carried over from
``sod_tpu`` load alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sod_tpu_torch.ops.attention import Attention
from sod_tpu_torch.ops.fused_attn import fused_ln_attn_infer
from sod_tpu_torch.ops.fused_block import fused_vit_block
from sod_tpu_torch.ops.fused_mlp import fused_ln_mlp
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
    (``_block_apply``), its attention through K2 under ``cfg.use_flash``,
    False keys of ``key_mask`` [B, N] excluded."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, LN_EPS)
        self.attn = Attention(d, cfg.n_heads, use_flash=cfg.use_flash)
        self.norm2 = LayerNorm(d, LN_EPS)
        self.mlp = Mlp(d, MLP_RATIO * d)

    def forward(self, x, key_mask=None):
        x = x + self.attn(self.norm1(x), key_mask)
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


def prepare_tokens(vit: VisionTransformer, x: torch.Tensor,
                   pos_embed_override: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patchify + CLS + interpolated pos-embed: ([B, 1+N, D], grid).

    :param pos_embed_override: [B or 1, 1+N, D] positional embeddings used
        in place of the interpolated table (the canvas evaluator's
        per-image embeddings, ``pos_embed_canvas_device``)."""
    cfg = vit.cfg
    x = make_input_divisible(x, cfg.patch_size)
    gh, gw = x.shape[1] // cfg.patch_size, x.shape[2] // cfg.patch_size
    tokens = patchify(x, vit.patch_embed.proj.weight,
                      vit.patch_embed.proj.bias, cfg.patch_size)
    b, _, d = tokens.shape
    cls = vit.cls_token.to(tokens.dtype).expand(b, 1, d)
    tokens = torch.cat([cls, tokens], dim=1)
    if pos_embed_override is not None:
        pe = pos_embed_override
    else:
        pe = interpolate_pos_encoding(vit.pos_embed, (gh, gw), cfg.pos_grid)
    return tokens + pe.to(tokens.dtype), (gh, gw)


def vit_apply(vit: VisionTransformer, x: torch.Tensor,
              fused: bool = False,
              token_mask: Optional[torch.Tensor] = None,
              pos_embed_override: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Encoder forward: the final-LayerNormed last-layer tokens [B, 1+N, D].

    :param x: [B, H, W, 3] normalized images.
    :param token_mask: [B, 1+N] bool; False tokens (canvas padding) are
        excluded as attention keys.
    :param pos_embed_override: see ``prepare_tokens``.
    :param fused: inference path through the fused kernels for bf16
        tokens, padded once to a multiple of 128 before the layer loop,
        with ``sod_tpu``'s guard (``vit.py:324-389``): the whole-block
        kernel K1 for n_pad <= 1024 and D <= 512, else the gridded K5
        (attention half) then K4 (MLP half) per block.  An f32 request runs
        the unfused erf-GELU blocks, as in ``sod_tpu``.
    """
    cfg = vit.cfg
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    if fused and tokens.dtype == torch.bfloat16:
        b, n, d = tokens.shape
        n_pad = -(-n // 128) * 128
        out = F.pad(tokens, (0, 0, 0, n_pad - n))
        kmask = (None if token_mask is None
                 else F.pad(token_mask, (0, n_pad - n)))
        for blk in vit.blocks:
            if n_pad <= 1024 and d <= 512:
                out = fused_vit_block(out, blk, cfg.n_heads, n_real=n,
                                      key_mask=kmask, eps=LN_EPS)
            else:
                out = fused_ln_attn_infer(out, blk, cfg.n_heads, n_real=n,
                                          key_mask=kmask, eps=LN_EPS)
                out = fused_ln_mlp(out, blk, eps=LN_EPS)
        return vit.norm(out[:, :n])
    for blk in vit.blocks:
        tokens = blk(tokens, token_mask)
    return vit.norm(tokens)


def _dynamic_resize_matrix(in_size: int, out_size: int,
                           n_valid: torch.Tensor) -> torch.Tensor:
    """Bicubic interpolation matrices [B, out_size, in_size] for per-image
    target lengths ``n_valid`` [B] <= out_size (rows >= n_valid are garbage
    for the caller to mask): ``_resize_matrix``'s math (torch's A=-0.75
    kernel, half-pixel centres, edge-clamped taps) in f32 with the scale a
    tensor, as ``sod_tpu/models/vit.py:545-569``."""
    a = -0.75
    dev = n_valid.device
    # a tensor divided by a tensor: torch turns `int / tensor` into a product
    # with the reciprocal
    scale = torch.tensor(float(in_size), device=dev) / n_valid.float()[:, None]
    dst = torch.arange(out_size, dtype=torch.float32, device=dev)
    src = (dst + 0.5) * scale - 0.5
    i0 = torch.floor(src)
    frac = src - i0
    cols = torch.arange(in_size, device=dev)
    mat = torch.zeros(n_valid.shape[0], out_size, in_size, device=dev)
    for t in range(-1, 3):
        x = (t - frac).abs()
        x2 = x * x
        x3 = x2 * x
        w = torch.where(x <= 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
                        torch.where(x < 2.0,
                                    a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a,
                                    torch.zeros_like(x)))
        idx = (i0 + t).clamp(0, in_size - 1).long()
        mat = mat + w[..., None] * (cols == idx[..., None])
    return mat


def pos_embed_canvas_device(pos_embed: torch.Tensor, gh: torch.Tensor,
                            gw: torch.Tensor, canvas_grid_hw) -> torch.Tensor:
    """Per-image positional embeddings of a canvas batch, on the device:
    the [G, G] table bicubic-resized to each image's true grid (gh, gw),
    top-left in the canvas grid, zeros elsewhere (those tokens are masked).
    An image whose grid is the table's own takes the table as it is (the
    reference's early return, ``sod_tpu/models/vit.py:594-598``).

    :param pos_embed: [1, G*G + 1, D] table; gh, gw: [B] integer grids.
    :return: [B, 1 + Gh*Gw, D] f32.
    """
    gh_c, gw_c = canvas_grid_hw
    d = pos_embed.shape[-1]
    pos_grid = int(round((pos_embed.shape[1] - 1) ** 0.5))
    b = gh.shape[0]
    table = pos_embed[0, 1:].reshape(pos_grid, pos_grid, d).float()
    mh = _dynamic_resize_matrix(pos_grid, gh_c, gh)
    mw = _dynamic_resize_matrix(pos_grid, gw_c, gw)
    out = torch.einsum("bHh,hwd,bWw->bHWd", mh, table, mw)
    native = torch.zeros(gh_c, gw_c, d, device=table.device)
    if pos_grid <= gh_c and pos_grid <= gw_c:
        native[:pos_grid, :pos_grid] = table
    same = ((gh == pos_grid) & (gw == pos_grid))[:, None, None, None]
    out = torch.where(same, native, out)
    ok = ((torch.arange(gh_c, device=gh.device) < gh[:, None])[:, :, None]
          & (torch.arange(gw_c, device=gw.device) < gw[:, None])[:, None, :])
    out = torch.where(ok[..., None], out, torch.zeros_like(out))
    cls = pos_embed[0, :1].float().expand(b, 1, d)
    return torch.cat([cls, out.reshape(b, gh_c * gw_c, d)], dim=1)
