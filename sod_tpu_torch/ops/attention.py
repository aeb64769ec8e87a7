"""Multi-head attention of the port (twin of ``sod_tpu/ops/attention.py``).

Explicit matmuls and softmax, with ``sod_tpu``'s rounding points: f32
logits and softmax, masked keys at -1e30, probabilities cast to
``v.dtype`` before p.v, the p.v product accumulated in f32 and cast back.
The ViT self-attention can route through the flash attention kernel K2
(``ops/flash_attention.py``), as ``sod_tpu``'s ``use_flash`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sod_tpu_torch.ops.flash_attention import flash_attention
from sod_tpu_torch.ops.layers import Linear, linear


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, N, hd].

    :param key_mask: optional [B, Nk] bool; False keys leave the softmax."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


def self_attention_qkv(qkv: Linear, proj: Linear, x: torch.Tensor,
                       n_heads: int,
                       key_mask: Optional[torch.Tensor] = None,
                       use_flash: bool = False) -> torch.Tensor:
    """ViT fused-QKV self-attention over x [B, N, D]; qkv columns [q|k|v].

    :param use_flash: softmax(q k^T) v through ``flash_attention`` (K2;
        ``sod_tpu/ops/attention.py:89-92``), else through ``sdpa``."""
    b, n, d = x.shape
    hd = d // n_heads
    y = qkv(x).reshape(b, n, 3, n_heads, hd)
    q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
    if use_flash:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              hd ** -0.5, key_mask)
    else:
        out = sdpa(q, k, v, hd ** -0.5, key_mask)
    return proj(_merge_heads(out))


def multi_head_attention(attn: "MultiheadAttention", query: torch.Tensor,
                         key: torch.Tensor, value: torch.Tensor,
                         key_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` math, batch first: the packed
    in_proj rows are [q | k | v] (the reference's (3D, D) layout)."""
    d = query.shape[-1]
    h = attn.n_heads
    w, bias = attn.in_proj_weight, attn.in_proj_bias
    q, k, v = (_split_heads(linear(t, w[i * d:(i + 1) * d],
                                   bias[i * d:(i + 1) * d]), h)
               for i, t in enumerate((query, key, value)))
    out = sdpa(q, k, v, (d // h) ** -0.5, key_mask)
    return attn.out_proj(_merge_heads(out))


class Attention(nn.Module):
    """ViT attention parameters (``attn.qkv``, ``attn.proj``)."""

    def __init__(self, dim: int, n_heads: int, use_flash: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.use_flash = use_flash
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, key_mask=None):
        return self_attention_qkv(self.qkv, self.proj, x, self.n_heads,
                                  key_mask=key_mask, use_flash=self.use_flash)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names: ``in_proj_weight``
    (3D, D), ``in_proj_bias``, ``out_proj``."""

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, query, key, value, key_mask=None):
        return multi_head_attention(self, query, key, value, key_mask)
