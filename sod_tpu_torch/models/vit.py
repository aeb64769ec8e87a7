"""DINO-variant ViT encoder of the port (twin of ``sod_tpu/models/vit.py``).

Images are NHWC [B, H, W, 3]; tokens [B, N, D] with CLS at index 0.
Parameter names follow the reference's ``vision_transformer.py`` (DINO
``deit_small``), so a real checkpoint and weights carried over from
``sod_tpu`` load alike.  Besides the forward (``vit_apply``): the
attention-map and token helpers of the DINO toolkit (``vit_selfattention``,
``vit_get_tokens``, ``vit_n_last_*``), the DINO head, and ``vit_init``.

``dinov2_vitg14_reg`` is DINOv2's ViT-g/14 with registers (Oquab et al.,
arXiv:2304.07193; Darcet et al., arXiv:2309.16588; facebookresearch/dinov2
``vit_giant2``), under the hub's parameter names: its blocks scale both
residual branches by LayerScale gammas (``ls1.gamma``, ``ls2.gamma``) and
run a SwiGLU FFN (``mlp.w12``, ``mlp.w3``); ``register_tokens`` sit between
CLS and the patches and carry no position embedding; the position table is
resized bicubic with antialiasing at other grids.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sod_tpu_torch.ops.attention import Attention
from sod_tpu_torch.ops.fused_attn import fused_ln_attn, fused_ln_attn_infer
from sod_tpu_torch.ops.fused_block import fused_vit_block
from sod_tpu_torch.ops.fused_block_int8 import fused_vit_block_int8
from sod_tpu_torch.ops.fused_mlp import fused_ln_mlp
from sod_tpu_torch.ops.layers import (LayerNorm, Linear, gelu, layer_norm_init, linear,
                                      linear_init, mlp_apply, mlp_init, trunc_normal)
from sod_tpu_torch.ops.resize import interpolate_bicubic


LN_EPS = 1e-6                     # the reference ViT's LayerNorm eps
MLP_RATIO = 4
DINOV2_ARCH = "dinov2_vitg14_reg"
DINOV2_REGISTERS = 4


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    n_heads: int = 6
    pos_grid: int = 28            # the pretrained 224-px pos-embed grid
    use_flash: bool = False       # self-attention through the K2 kernels
    fused_mlp: bool = False       # the block's MLP half through K4
    fused_train: bool = False     # training blocks through K3 then K4
    fused_save_acts: bool = False  # K3 keeps qkv, K4 the pre-GELU hidden
    remat: bool = False           # recompute each block in the backward
    dinov2: bool = False          # DINOv2 blocks (LayerScale, SwiGLU), registers, antialiased
                                  # pos resize

    @property
    def n_pos_tokens(self) -> int:
        return self.pos_grid * self.pos_grid + 1

    @property
    def n_registers(self) -> int:
        """Register tokens between CLS and the patches (DINOv2 "reg")."""
        return DINOV2_REGISTERS if self.dinov2 else 0

    @property
    def ffn_hidden(self) -> int:
        """The FFN's hidden width: 4 d, or DINOv2's SwiGLU width
        ``(int(4 d * 2 / 3) + 7) // 8 * 8`` (``SwiGLUFFNFused``)."""
        hidden = MLP_RATIO * self.embed_dim
        return (int(hidden * 2 / 3) + 7) // 8 * 8 if self.dinov2 else hidden


def vit_small(patch_size: int = 8, use_flash: bool = False,
              fused_mlp: bool = False, fused_train: bool = False,
              fused_save_acts: bool = False, remat: bool = False) -> ViTConfig:
    """deit_small: d 384, 6 heads, 12 blocks."""
    return ViTConfig(patch_size=patch_size, embed_dim=384, n_heads=6,
                     pos_grid=224 // patch_size, use_flash=use_flash,
                     fused_mlp=fused_mlp, fused_train=fused_train,
                     fused_save_acts=fused_save_acts, remat=remat)


def vit_tiny(patch_size: int = 16, use_flash: bool = False) -> ViTConfig:
    """deit_tiny: d 192, 3 heads, 12 blocks."""
    return ViTConfig(patch_size=patch_size, embed_dim=192, n_heads=3,
                     pos_grid=224 // patch_size, use_flash=use_flash)


def vit_base(patch_size: int = 16, use_flash: bool = False) -> ViTConfig:
    """deit_base: d 768, 12 heads, 12 blocks."""
    return ViTConfig(patch_size=patch_size, embed_dim=768, n_heads=12,
                     pos_grid=224 // patch_size, use_flash=use_flash)


def dinov2_vitg14_reg(patch_size: int = 14, use_flash: bool = False,
                      remat: bool = False) -> ViTConfig:
    """DINOv2 ``dinov2_vitg14_reg``: d 1536, 24 heads of 64, 40 blocks,
    SwiGLU hidden 4096, LayerScale, 4 registers, the 37 x 37 position grid
    of 518 px.  Patch 14 only."""
    if patch_size != 14:
        raise ValueError(f"{DINOV2_ARCH} has patch 14, got patch_size={patch_size}")
    return ViTConfig(patch_size=14, embed_dim=1536, depth=40, n_heads=24, pos_grid=37,
                     use_flash=use_flash, remat=remat, dinov2=True)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return mlp_apply([self.fc1, self.fc2], x, activation="gelu")


class SwiGLUFFN(nn.Module):
    """DINOv2's SwiGLU FFN: ``w3(silu(x1) * x2)`` with ``x1, x2 =
    w12(x).chunk(2)``, both linears through ``linear``, the gate in the
    tokens' dtype."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    """DINOv2's per-channel scale of a residual branch, ``gamma`` f32,
    rounded to the branch's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm encoder block; ``forward`` is the unfused path
    (``_block_apply``), its attention through K2 under ``cfg.use_flash``,
    False keys of ``key_mask`` [B, N] excluded; its MLP half is the erf-GELU
    ``Mlp``, or under ``cfg.fused_mlp`` the tanh-GELU kernel K4 with the
    recompute backward (``sod_tpu/models/vit.py:238-241``).  A DINOv2 block
    (``cfg.dinov2``) is ``x + ls1(attn(norm1(x)))``, then ``x +
    ls2(mlp(norm2(x)))`` with the ``SwiGLUFFN``, its modules in the hub's
    order."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.fused_mlp = cfg.fused_mlp
        self.norm1 = LayerNorm(d, LN_EPS)
        self.attn = Attention(d, cfg.n_heads, use_flash=cfg.use_flash)
        self.ls1 = LayerScale(d) if cfg.dinov2 else None
        self.norm2 = LayerNorm(d, LN_EPS)
        self.mlp = SwiGLUFFN(d, cfg.ffn_hidden) if cfg.dinov2 else Mlp(d, MLP_RATIO * d)
        self.ls2 = LayerScale(d) if cfg.dinov2 else None

    def forward(self, x, key_mask=None, return_attn: bool = False):
        """:param return_attn: return ``(x, probs)``, the attention's f32
        probabilities [B, H, N, N] beside the output, with the plain
        softmax and the block's own MLP whatever ``cfg`` says
        (``sod_tpu``'s ``_block_apply(return_attn=...)``)."""
        if return_attn:
            y, probs = self.attn(self.norm1(x), key_mask, return_attn=True)
            x = x + _scaled(self.ls1, y)
            return x + _scaled(self.ls2, self.mlp(self.norm2(x))), probs
        x = x + _scaled(self.ls1, self.attn(self.norm1(x), key_mask))
        if self.fused_mlp:
            return fused_ln_mlp(x, self, eps=LN_EPS)
        return x + _scaled(self.ls2, self.mlp(self.norm2(x)))


def _scaled(ls: Optional[LayerScale], y: torch.Tensor) -> torch.Tensor:
    return y if ls is None else ls(y)


def fused_block_train(blk: Block, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Training path through the fused kernels: the block as K3
    (``fused_ln_attn``) then K4 (``fused_ln_mlp``), each with a kernel in
    both directions (``sod_tpu/models/vit.py:247-279``).  K3 keeps the
    attention output for its backward unless ``cfg.fused_save_acts`` (it
    keeps qkv then, and K4 its pre-GELU hidden) or the environment variable
    ``SOD_NO_SAVE_ATTN`` is set (nothing kept: the recompute backward)."""
    x1 = fused_ln_attn(x, blk, cfg.n_heads, eps=LN_EPS,
                       save_acts=cfg.fused_save_acts,
                       save_attn=not (cfg.fused_save_acts
                                      or os.environ.get("SOD_NO_SAVE_ATTN")))
    return fused_ln_mlp(x1, blk, eps=LN_EPS, save_acts=cfg.fused_save_acts)


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
                             pos_grid: int, antialias: bool = False) -> torch.Tensor:
    """Bicubic-resize the (G*G+1)-token pos-embed to (gh*gw+1) tokens; with
    ``antialias`` as DINOv2 does (``interpolate_antialias=True``, no
    ``interpolate_offset``: ``F.interpolate`` to the grid's size, in f32)."""
    gh, gw = grid_hw
    if gh == pos_grid and gw == pos_grid:
        return pos_embed
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    d = pos_embed.shape[-1]
    patch_pe = patch_pe.reshape(1, pos_grid, pos_grid, d).permute(0, 3, 1, 2)
    if antialias:
        patch_pe = F.interpolate(patch_pe.float(), size=(gh, gw), mode="bicubic",
                                 align_corners=False, antialias=True).to(pos_embed.dtype)
    else:
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
        if cfg.n_registers:
            self.register_tokens = nn.Parameter(torch.empty(1, cfg.n_registers, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, LN_EPS)


def prepare_tokens(vit: VisionTransformer, x: torch.Tensor,
                   pos_embed_override: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patchify + CLS + interpolated pos-embed: ([B, 1+N, D], grid); then
    the register tokens, if any, after CLS ([B, 1+R+N, D], DINOv2's
    ``prepare_tokens_with_masks``).

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
        pe = interpolate_pos_encoding(vit.pos_embed, (gh, gw), cfg.pos_grid, cfg.dinov2)
    tokens = tokens + pe.to(tokens.dtype)
    if cfg.n_registers:
        regs = vit.register_tokens.to(tokens.dtype).expand(b, -1, d)
        tokens = torch.cat([tokens[:, :1], regs, tokens[:, 1:]], dim=1)
    return tokens, (gh, gw)


def vit_apply(vit: VisionTransformer, x: torch.Tensor,
              fused: bool = False,
              token_mask: Optional[torch.Tensor] = None,
              pos_embed_override: Optional[torch.Tensor] = None,
              all_layers: bool = False) -> torch.Tensor:
    """Encoder forward: the final-LayerNormed last-layer tokens [B, 1+N, D].

    :param x: [B, H, W, 3] normalized images.
    :param token_mask: [B, 1+N] bool; False tokens (canvas padding) are
        excluded as attention keys.
    :param pos_embed_override: see ``prepare_tokens``.
    :param all_layers: return every block's final-LayerNormed tokens
        stacked as [L, B, 1+N, D] instead (``sod_tpu``'s default; the
        port's callers read the last layer only).
    :param fused: inference path through the fused kernels for bf16
        tokens, padded once to a multiple of 128 before the layer loop,
        with ``sod_tpu``'s guard (``vit.py:323-389``): a whole-block kernel
        for n_pad <= 1024, which is the int8 block K8 up to D 768 when the
        encoder carries quantised blocks (``vit.blocks_q``, set by
        ``ops.fused_block_int8.vit_quantize_int8``), else K1 up to D 512;
        beyond either bound the gridded K5 (attention half) then K4 (MLP
        half) per block, on the float weights.  An f32 request runs the
        unfused erf-GELU blocks, as in ``sod_tpu``.

    Otherwise, under ``cfg.fused_train`` and without a token mask, every
    block runs ``fused_block_train`` (K3 then K4, differentiable, and
    ``cfg.remat`` is ignored: the kernels' backward recomputes already);
    with a token mask the block runs unfused, as in ``sod_tpu``
    (``vit.py:391-402``).  Under ``cfg.remat`` an unfused block keeps only
    its input for the backward and runs its forward again there
    (``torch.utils.checkpoint``, non-reentrant): K2 under ``use_flash`` and
    K4 under ``fused_mlp`` launch twice forward per backward.
    """
    cfg = vit.cfg
    if fused and cfg.dinov2:
        raise ValueError(f"{DINOV2_ARCH}: the fused inference kernels (K1, K4, K5, K8) run "
                         f"GELU blocks; this arch's SwiGLU blocks have none")
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    per_layer = []
    if fused and tokens.dtype == torch.bfloat16:
        b, n, d = tokens.shape
        n_pad = -(-n // 128) * 128
        out = F.pad(tokens, (0, 0, 0, n_pad - n))
        kmask = (None if token_mask is None
                 else F.pad(token_mask, (0, n_pad - n)))
        blocks_q = getattr(vit, "blocks_q", None)
        whole = n_pad <= 1024 and d <= (768 if blocks_q is not None else 512)
        for i, blk in enumerate(vit.blocks):
            if whole and blocks_q is not None:
                out = fused_vit_block_int8(out, blocks_q[i], cfg.n_heads,
                                           n_real=n, key_mask=kmask,
                                           eps=LN_EPS)
            elif whole:
                out = fused_vit_block(out, blk, cfg.n_heads, n_real=n,
                                      key_mask=kmask, eps=LN_EPS)
            else:
                out = fused_ln_attn_infer(out, blk, cfg.n_heads, n_real=n,
                                          key_mask=kmask, eps=LN_EPS)
                out = fused_ln_mlp(out, blk, eps=LN_EPS)
            if all_layers:
                per_layer.append(vit.norm(out[:, :n]))
        return torch.stack(per_layer) if all_layers else vit.norm(out[:, :n])
    for blk in vit.blocks:
        if cfg.fused_train and token_mask is None:
            tokens = fused_block_train(blk, tokens, cfg)
        elif cfg.remat and torch.is_grad_enabled():
            tokens = checkpoint(blk, tokens, token_mask, use_reentrant=False)
        else:
            tokens = blk(tokens, token_mask)
        if all_layers:
            per_layer.append(vit.norm(tokens))
    return torch.stack(per_layer) if all_layers else vit.norm(tokens)


def vit_last_selfattention(vit: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """The last block's attention probabilities [B, H, 1+N, 1+N] (the
    reference's ``get_last_selfattention``); the blocks before it run as
    ``vit_apply``'s unfused path does (K2 under ``use_flash``)."""
    tokens, _ = prepare_tokens(vit, x)
    for blk in vit.blocks[:-1]:
        tokens = blk(tokens)
    return vit.blocks[-1](tokens, return_attn=True)[1]


def vit_selfattention(vit: VisionTransformer, x: torch.Tensor,
                      all_blocks: bool = False) -> torch.Tensor:
    """Attention probabilities of the last block [B, H, 1+N, 1+N], or with
    ``all_blocks`` of every block [L, B, H, 1+N, 1+N] (the reference's
    ``forward_selfattention``): every block through the plain softmax."""
    tokens, _ = prepare_tokens(vit, x)
    attns = []
    for blk in vit.blocks:
        tokens, probs = blk(tokens, return_attn=True)
        attns.append(probs)
    return torch.stack(attns) if all_blocks else attns[-1]


def vit_get_tokens(vit: VisionTransformer, x: torch.Tensor,
                   layers: Optional[Sequence[int]] = None,
                   patch_tokens: bool = False, norm: bool = True) -> torch.Tensor:
    """Tokens of every block (or of ``layers``) [B, L', 1+N, D], or their CLS
    tokens [B, L', D] without ``patch_tokens`` (the reference's
    ``get_tokens``).

    :param norm: each layer through the final LayerNorm (``vit_apply(...,
        all_layers=True)``, K2 under ``use_flash``); False: the raw block
        outputs."""
    if norm:
        stacked = vit_apply(vit, x, all_layers=True)          # [L, B, 1+N, D]
    else:
        tokens, _ = prepare_tokens(vit, x)
        raw = []
        for blk in vit.blocks:
            tokens = blk(tokens)
            raw.append(tokens)
        stacked = torch.stack(raw)
    if layers is not None:
        stacked = stacked[list(layers)]
    stacked = stacked.transpose(0, 1)                         # [B, L', 1+N, D]
    return stacked if patch_tokens else stacked[:, :, 0]


def vit_n_last_cls(vit: VisionTransformer, x: torch.Tensor, n: int = 1,
                   return_patch_avgpool: bool = False) -> torch.Tensor:
    """CLS tokens of the n last blocks concatenated [B, n * D] (the
    reference's ``forward_return_n_last_blocks``), then the last block's
    mean patch token with ``return_patch_avgpool``."""
    stacked = vit_apply(vit, x, all_layers=True)
    outs = [stacked[-(n - i)][:, 0] for i in range(n)]
    if return_patch_avgpool:
        outs.append(stacked[-1][:, 1:].mean(dim=1))
    return torch.cat(outs, dim=-1)


def vit_n_last_patch_emb(vit: VisionTransformer, x: torch.Tensor,
                         n: int = 1) -> torch.Tensor:
    """Patch tokens of the n last blocks stacked on a trailing axis
    [B, N, D, n] (the reference's ``return_patch_emb_from_n_last_blocks``)."""
    stacked = vit_apply(vit, x, all_layers=True)
    return torch.stack([stacked[-(n - i)][:, 1:] for i in range(n)], dim=-1)


def dino_head_init(gen: torch.Generator, in_dim: int, out_dim: int, nlayers: int = 3,
                   hidden_dim: int = 2048, bottleneck_dim: int = 256) -> Dict:
    """The DINO projection head (``sod_tpu``'s ``dino_head_init``): the MLP
    in -> hidden x (nlayers - 1) -> bottleneck as ``trunc_normal`` linears
    (``{"mlp": [{"weight", "bias"}, ...]}``), and the weight-normed last
    layer's direction ``last_v`` (out_dim, bottleneck) N(0, 0.02) with its
    gain ``last_g`` (out_dim,) ones."""
    nlayers = max(nlayers, 1)
    dims = ([in_dim, bottleneck_dim] if nlayers == 1
            else [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim])
    return {"mlp": mlp_init(gen, dims),
            "last_v": torch.randn(out_dim, bottleneck_dim, generator=gen) * 0.02,
            "last_g": torch.ones(out_dim)}


def dino_head_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """MLP with erf-GELU between its linears, the output L2-normalised, then
    the weight-normed last layer (each output row of ``last_v`` normalised,
    times its gain), accumulated in f32 and cast back to ``x.dtype``."""
    mlp: List[Dict[str, torch.Tensor]] = params["mlp"]
    h = x
    for i, fc in enumerate(mlp):
        h = linear(h, fc["weight"], fc["bias"])
        if i < len(mlp) - 1:
            h = gelu(h)
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-12)
    v = params["last_v"]
    v_unit = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-12)
    w = v_unit * params["last_g"][:, None]
    return torch.matmul(h.float(), w.to(h.dtype).float().t()).to(h.dtype)


def vit_init(gen: torch.Generator, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """A ``VisionTransformer(cfg)`` state dict with ``sod_tpu``'s
    ``vit_init`` distributions, drawn from ``gen``: the patch conv
    torch-default U(+-1/sqrt(3 p^2)) (weight and bias), CLS zeros, the
    pos-embed and every block linear ``trunc_normal`` with zero biases,
    LayerNorms ones and zeros.  A DINOv2 config takes DINOv2's
    ``init_weights``: CLS and registers N(0, 1e-6), the SwiGLU linears
    ``trunc_normal``, the LayerScale gammas the hub's ``init_values`` 1."""
    d, p = cfg.embed_dim, cfg.patch_size
    patch = linear_init(gen, p * p * 3, d, init="torch_default")
    out = {
        # the linear's rows are flattened (py, px, c); the conv is (D, C, py, px)
        "patch_embed.proj.weight": patch["weight"].reshape(d, p, p, 3).permute(0, 3, 1, 2)
        .contiguous(),
        "patch_embed.proj.bias": patch["bias"],
        "cls_token": (torch.randn(1, 1, d, generator=gen) * 1e-6 if cfg.dinov2
                      else torch.zeros(1, 1, d)),
        "pos_embed": trunc_normal(gen, (1, cfg.n_pos_tokens, d)),
    }
    if cfg.n_registers:
        out["register_tokens"] = torch.randn(1, cfg.n_registers, d, generator=gen) * 1e-6
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        lins = {"attn.qkv": linear_init(gen, d, 3 * d), "attn.proj": linear_init(gen, d, d)}
        if cfg.dinov2:
            h = cfg.ffn_hidden
            lins.update({"mlp.w12": linear_init(gen, d, 2 * h), "mlp.w3": linear_init(gen, h, d),
                         "ls1": {"gamma": torch.ones(d)}, "ls2": {"gamma": torch.ones(d)}})
        else:
            fc1, fc2 = mlp_init(gen, [d, MLP_RATIO * d, d])
            lins.update({"mlp.fc1": fc1, "mlp.fc2": fc2})
        lins.update({"norm1": layer_norm_init(d), "norm2": layer_norm_init(d)})
        for name, t in lins.items():
            out.update({f"{pre}{name}.{k}": v for k, v in t.items()})
    out.update({f"norm.{k}": v for k, v in layer_norm_init(d).items()})
    return out


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


def random_vit_state_dict(model: nn.Module, seed: int) -> dict:
    """Seeded f32 weights for a ``VisionTransformer`` (or a model built on
    one, the DeiT), from ``sod_tpu``'s ``vit_init`` distributions drawn with
    numpy (``jax.random`` cannot be matched): the block linears, the
    pos-embed, the distillation token and the heads N(0, 0.02) clipped at
    +-2 with zero biases, LayerNorms ones and zeros, CLS zeros, the patch
    conv torch-default U(+-1/sqrt(fan_in)); a DINOv2 ViT's CLS and registers
    N(0, 1e-6) and its LayerScale gammas ones (``vit_init``)."""
    rng = np.random.default_rng(seed)
    out = {}
    dinov2 = getattr(model.cfg, "dinov2", False)
    for name, p in model.state_dict().items():
        shape, parts = tuple(p.shape), name.split(".")
        if name.startswith("patch_embed."):
            bound = 1 / math.sqrt(3 * model.cfg.patch_size ** 2)
            a = rng.uniform(-bound, bound, shape)
        elif dinov2 and name in ("cls_token", "register_tokens"):
            a = rng.normal(0.0, 1e-6, shape)
        elif parts[-1] == "gamma":
            a = np.ones(shape)
        elif name == "cls_token":
            a = np.zeros(shape)
        elif len(parts) > 1 and parts[-2].startswith("norm") or name.startswith("norm."):
            a = np.ones(shape) if parts[-1] == "weight" else np.zeros(shape)
        elif parts[-1] == "bias":
            a = np.zeros(shape)
        else:                       # block and head linears, pos-embed, dist token
            a = np.clip(rng.normal(0.0, 0.02, shape), -2.0, 2.0)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out
