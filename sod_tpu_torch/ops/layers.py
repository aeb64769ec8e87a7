"""Neural-net primitives of the port (twin of ``sod_tpu/ops/layers.py``).

Conventions:

* weights are in the torch ``nn.Linear`` layout (out, in), as in the
  reference's state dicts; ``sod_tpu`` stores (in, out);
* every product runs on f32 copies of its operands and the bias is added in
  f32 before the one cast back to the input dtype, which is exactly
  ``sod_tpu``'s bf16 x bf16 -> f32 accumulation (a bf16 x bf16 product is
  exact in f32);
* LayerNorm is f32 math with a two-pass variance.

The ``nn.Module`` classes only hold parameters under the reference's key
names; their ``forward`` calls the functions.  Parameters start
uninitialised: a state dict or ``models.maskformer.random_state_dict``
fills them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x . weight^T + bias`` in f32, cast back to ``x.dtype``.  The weight
    is first rounded to ``x.dtype`` (``sod_tpu``'s ``w.astype(x.dtype)``:
    f32 master weights meet bf16 activations as bf16); the bias stays f32."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32, cast back to ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU``'s default.  Below f32 it keeps
    the rounding points of ``jax.nn.gelu(approximate=False)`` as written,
    ``0.5 * x * erfc(-x * sqrt(0.5))`` with each product rounded to
    ``x.dtype``, instead of one rounding of an f32 GELU."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x)
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def mlp_apply(layers: Sequence["Linear"], x: torch.Tensor,
              activation: str = "gelu") -> torch.Tensor:
    """Linears with ``activation`` between them (none after the last):
    ``gelu`` for the ViT ``Mlp``, ``relu`` for the DETR objectness head."""
    act = {"gelu": gelu, "relu": torch.relu}[activation]
    for i, layer in enumerate(layers):
        x = linear(x, layer.weight, layer.bias)
        if i < len(layers) - 1:
            x = act(x)
    return x


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
