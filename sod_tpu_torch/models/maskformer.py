"""MaskFormer saliency model of the port (twin of
``sod_tpu/models/maskformer.py``), live configuration only: ViT-S encoder,
DETR post-norm decoder, bilinear pixel decoder, binary objectness head.

Parameter names are the reference's ``selfmask_nq20.pt`` keys
(``encoder.*``, ``decoder.layers.{i}.*``, ``decoder.norm.*``,
``query_embed``, ``ffn.layers.{i}.*``).  Layouts: images NHWC, queries
[B, L, Q, D], ``mask_pred`` [B, L, Q, h, w].
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from sod_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_apply, vit_small
from sod_tpu_torch.ops.attention import MultiheadAttention
from sod_tpu_torch.ops.layers import LayerNorm, Linear, mlp_apply
from sod_tpu_torch.ops.resize import interpolate_bilinear

DECODER_LN_EPS = 1e-5                   # torch nn.LayerNorm's default


@dataclass(frozen=True)
class MaskFormerConfig:
    n_queries: int = 20
    n_decoder_layers: int = 6
    scale_factor: int = 2
    vit: ViTConfig = field(default_factory=vit_small)

    @property
    def embed_dim(self) -> int:
        return self.vit.embed_dim

    @property
    def n_heads(self) -> int:
        return self.vit.n_heads


# (Config field, the one value the port runs, where the rest is queued)
_LIVE_ONLY = (
    ("arch", "vit_small", "ROADMAP item 8, models/resnet.py"),
    ("use_binary_classifier", True,
     "ROADMAP item 13, the non-bc head and the Hungarian loss branch"),
    ("learnable_pixel_decoder", False,
     "ROADMAP item 13, the learnable pixel decoder"),
    ("quantize", "none", "ROADMAP item 9, int8 serving with kernel K8"),
    ("use_fused_eval", False, "ROADMAP item 7, kernels K5 and K4"),
    ("use_fused_mlp", False, "ROADMAP kernel K4"),
    ("use_fused_train", False, "ROADMAP item 6, kernels K3 and K4"),
    ("remat", False, "ROADMAP item 6, block rematerialisation"),
    ("use_copy_paste", False, "ROADMAP item 6, copy-paste augmentation"),
    ("loss_every_decoder_layer", True,
     "ROADMAP item 6, the last-layer-only loss"),
    ("async_checkpoint", False, "ROADMAP item 6, AsyncSaver"),
    ("fsdp", "none", "ROADMAP item 12, parallel/fsdp.py"),
    ("mesh_data_axis", 1, "ROADMAP item 12, data parallelism"),
    ("mesh_model_axis", 1, "ROADMAP item 12, parallel/tp.py"),
    ("mesh_pipe_axis", 1, "ROADMAP item 12, parallel/pp.py"),
    ("mesh_seq_axis", 1, "ROADMAP item 12, parallel/sp.py"),
)


def config_from(cfg) -> MaskFormerConfig:
    """MaskFormerConfig from the flat experiment ``Config`` (any object
    with its fields).  Raises ``NotImplementedError`` for a setting off the
    live configuration instead of ignoring it.  ``use_pallas_attention``
    routes the encoder's self-attention through the K2 kernels
    (``sod_tpu/models/maskformer.py:94``)."""
    for key, live, where in _LIVE_ONLY:
        value = getattr(cfg, key, live)
        if value != live:
            raise NotImplementedError(
                f"{key}={value!r} is not ported to sod_tpu_torch ({where}); "
                f"the port runs {key}={live!r}")
    if (getattr(cfg, "grad_accum_mode", "averaged") == "exact"
            and getattr(cfg, "grad_accum_steps", 1) > 1):
        raise NotImplementedError(
            "grad_accum_mode='exact' is not ported to sod_tpu_torch (ROADMAP "
            "item 6, GradCache accumulation); the port runs 'averaged'")
    return MaskFormerConfig(
        n_queries=cfg.n_queries, n_decoder_layers=cfg.n_decoder_layers,
        scale_factor=cfg.scale_factor,
        vit=vit_small(patch_size=cfg.patch_size,
                      use_flash=getattr(cfg, "use_pallas_attention", True)))


class DecoderLayer(nn.Module):
    """DETR post-norm layer: self-attn -> cross-attn -> FFN, each followed
    by residual + LayerNorm (dropout is 0 in the live config)."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, n_heads)
        self.multihead_attn = MultiheadAttention(d, n_heads)
        self.linear1 = Linear(d, 4 * d)
        self.linear2 = Linear(4 * d, d)
        self.norm1 = LayerNorm(d, DECODER_LN_EPS)
        self.norm2 = LayerNorm(d, DECODER_LN_EPS)
        self.norm3 = LayerNorm(d, DECODER_LN_EPS)

    def forward(self, tgt, memory, query_pos):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory,
                                                   memory))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: MaskFormerConfig):
        super().__init__()
        d = cfg.embed_dim
        self.layers = nn.ModuleList(
            DecoderLayer(d, cfg.n_heads) for _ in range(cfg.n_decoder_layers))
        self.norm = LayerNorm(d, DECODER_LN_EPS)


class MLP(nn.Module):
    """DETR relu MLP (``ffn.layers.{i}``)."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))


def forward_transformer_decoder(model: "MaskFormer",
                                memory: torch.Tensor) -> torch.Tensor:
    """Queries through every decoder layer: [B, L, Q, D], each layer's
    output passed through the decoder's final LayerNorm."""
    b, _, d = memory.shape
    query_pos = model.query_embed.to(memory.dtype).expand(b, -1, d)
    tgt = torch.zeros_like(query_pos)
    per_layer = []
    for layer in model.decoder.layers:
        tgt = layer(tgt, memory, query_pos)
        per_layer.append(model.decoder.norm(tgt))
    return torch.stack(per_layer, dim=1)


def forward_pixel_decoder(patch_tokens: torch.Tensor, grid_hw,
                          scale_factor: int) -> torch.Tensor:
    """Bilinear x``scale_factor`` upsample: [B, N, D] -> [B, H, W, D]."""
    b, _, d = patch_tokens.shape
    h, w = grid_hw
    feats = patch_tokens.reshape(b, h, w, d).permute(0, 3, 1, 2)
    feats = interpolate_bilinear(feats, h * scale_factor, w * scale_factor)
    return feats.permute(0, 2, 3, 1)


class MaskFormer(nn.Module):
    def __init__(self, cfg: MaskFormerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.encoder = VisionTransformer(cfg.vit)
        self.decoder = TransformerDecoder(cfg)
        self.query_embed = nn.Parameter(torch.empty(cfg.n_queries, d))
        self.ffn = MLP([d, d, d, 1])

    def forward(self, x: torch.Tensor, fused: bool = False,
                encoder_apply: Optional[Callable] = None
                ) -> Dict[str, torch.Tensor]:
        """:param x: [B, H, W, 3] normalized images.
        :param fused: run the encoder blocks through the fused kernel.
        :param encoder_apply: optional ``(encoder, x) -> [B, 1+N, D]``
            normed last-layer tokens used in place of the encoder; must be
            the same math as ``vit_apply``.
        :return: ``mask_pred`` [B, L, Q, h, w] and ``objectness``
            [B, L, Q, 1] (sigmoids, f32), ``features`` [B, D]."""
        p = self.cfg.vit.patch_size
        grid = (-(-x.shape[1] // p), -(-x.shape[2] // p))
        if encoder_apply is not None:
            tokens = encoder_apply(self.encoder, x)
        else:
            tokens = vit_apply(self.encoder, x, fused=fused)
        memory = tokens[:, 1:]

        queries = forward_transformer_decoder(self, memory)
        upsampled = forward_pixel_decoder(memory, grid, self.cfg.scale_factor)
        # f32 operands: bf16 einsum would round its logits to bf16
        mask_logits = torch.einsum("blqd,bhwd->blqhw", queries.float(),
                                   upsampled.float())
        objectness = mlp_apply(self.ffn.layers, queries.float(),
                               activation="relu")
        return {"mask_pred": torch.sigmoid(mask_logits),
                "objectness": torch.sigmoid(objectness),
                "features": queries[:, -1].mean(dim=1)}


def random_state_dict(model: MaskFormer, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights drawn from ``sod_tpu``'s init distributions
    (``maskformer_init``), with numpy: ViT linears and pos-embed N(0, 0.02)
    clipped at +-2, LayerNorms ones and zeros, CLS zeros, the patch conv and
    the decoder / head linears torch-default U(+-1/sqrt(fan_in)), in_proj
    xavier-uniform, out_proj U(+-1/sqrt(d)), queries N(0, 1)."""
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    out = {}
    for name, p in sd.items():
        shape = tuple(p.shape)
        parts = name.split(".")
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else None
        if name == "query_embed":
            a = rng.standard_normal(shape)
        elif parts[-2].startswith("norm"):
            a = np.ones(shape) if parts[-1] == "weight" else np.zeros(shape)
        elif name == "encoder.cls_token":
            a = np.zeros(shape)
        elif name == "encoder.pos_embed" or (parts[1] == "blocks"
                                             and parts[-1] == "weight"):
            a = np.clip(rng.normal(0.0, 0.02, shape), -2.0, 2.0)
        elif parts[1] == "blocks" or parts[-1] == "in_proj_bias" or (
                parts[-2] == "out_proj" and parts[-1] == "bias"):
            a = np.zeros(shape)
        elif parts[-1] == "in_proj_weight":
            bound = math.sqrt(6.0 / (shape[1] + shape[0]))
            a = rng.uniform(-bound, bound, shape)
        elif parts[-2] == "out_proj":
            a = rng.uniform(-1 / math.sqrt(shape[1]), 1 / math.sqrt(shape[1]),
                            shape)
        else:                           # patch conv, decoder linears, ffn
            if fan_in is None:          # a bias: fan-in of its weight
                fan_in = int(np.prod(sd[name[:-len("bias")] + "weight"]
                                     .shape[1:]))
            bound = 1 / math.sqrt(fan_in)
            a = rng.uniform(-bound, bound, shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out
