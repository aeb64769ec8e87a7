"""Neural-net primitives of the port (twin of ``sod_tpu/ops/layers.py``).

Conventions:

* weights are in the torch ``nn.Linear`` layout (out, in), as in the
  reference's state dicts; ``sod_tpu`` stores (in, out);
* a product is ``sod_tpu``'s bf16 x bf16 -> f32 accumulation (a bf16 x
  bf16 product is exact in f32), the f32 bias added to it before the one
  cast back to the input dtype.  ``linear`` takes it on the card's tensor
  cores for the bf16 CUDA calls that ``ops/gemm.py`` ``linear_takes``
  accepts (``linear_tc``: the port's own wgmma GEMM in both
  directions; only the order of the f32 sums differs); every other call
  (f32 inputs, the CPU, no bias, other shapes) runs on f32 copies of its
  operands;
* LayerNorm is f32 math with a two-pass variance.

The ``nn.Module`` classes only hold parameters under the reference's key
names; their ``forward`` calls the functions.  Parameters start
uninitialised: a state dict fills them, from ``models.maskformer``'s
``random_state_dict`` (numpy) or ``maskformer_init`` (a ``torch.Generator``,
through the ``*_init`` functions here, which draw ``sod_tpu``'s
distributions and return tensors under the torch names).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _norm_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02, mean: float = 0.0,
                 a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """``sod_tpu``'s truncated normal: U in [2 cdf(a') - 1, 2 cdf(b') - 1]
    (a' = (a - mean) / std), erfinv, scaled and shifted, clipped to [a, b];
    f32."""
    low = _norm_cdf((a - mean) / std)
    high = _norm_cdf((b - mean) / std)
    u = torch.rand(shape, generator=gen) * (2 * high - 2 * low) + (2 * low - 1)
    return (torch.erfinv(u) * (std * math.sqrt(2.0)) + mean).clamp(a, b)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def linear_init(gen: torch.Generator, in_features: int, out_features: int,
                bias: bool = True, init: str = "trunc_normal") -> Dict[str, torch.Tensor]:
    """``{"weight": (out, in), "bias": (out,)}`` as ``sod_tpu``'s
    ``linear_init``: ``trunc_normal`` N(0, 0.02) clipped at +-2 with a zero
    bias (the ViT's linears), or ``torch_default`` U(+-1/sqrt(in)) for both
    (the decoder's and the heads')."""
    if init == "trunc_normal":
        out = {"weight": trunc_normal(gen, (out_features, in_features))}
        if bias:
            out["bias"] = torch.zeros(out_features)
    elif init == "torch_default":
        bound = 1.0 / math.sqrt(in_features)
        out = {"weight": _uniform(gen, (out_features, in_features), bound)}
        if bias:
            out["bias"] = _uniform(gen, (out_features,), bound)
    else:
        raise ValueError(init)
    return out


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             init: str = "trunc_normal") -> List[Dict[str, torch.Tensor]]:
    """A stack of ``linear_init`` linears: dims = [in, hidden..., out]."""
    return [linear_init(gen, a, b, init=init) for a, b in zip(dims[:-1], dims[1:])]


def layer_norm_init(dim: int) -> Dict[str, torch.Tensor]:
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


tc_linears = 0                 # linear calls through ops/gemm.py linear_tc
f32_linears = 0                # bf16 linear calls on the card left on the f32 products
_count_lock = threading.Lock()


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x . weight^T + bias`` in f32, cast back to ``x.dtype``.  The weight
    is first rounded to ``x.dtype`` (``sod_tpu``'s ``w.astype(x.dtype)``:
    f32 master weights meet bf16 activations as bf16); the bias stays f32.
    Bf16 CUDA calls that ``ops/gemm.py`` ``linear_takes`` accepts run
    ``linear_tc``."""
    global tc_linears, f32_linears
    if x.dtype == torch.bfloat16 and _on_card(x):
        from sod_tpu_torch.ops import gemm      # gemm imports this module
        if gemm.linear_takes(x, weight, bias):
            with _count_lock:
                tc_linears += 1
            return gemm.linear_tc(x, weight, bias)
        with _count_lock:
            f32_linears += 1
    return linear_f32(x, weight, bias)


def linear_f32(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``linear`` on f32 copies of its operands: every call that
    ``linear_tc`` does not take."""
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



def _drop(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
          shape) -> torch.Tensor:
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and
    scaled by its inverse; the identity when ``rate`` is 0 or no generator
    is given (``sod_tpu``'s ``rng=None``).  Nothing calls it: the live
    config's dropout rates are 0."""
    return _drop(x, rate, generator, x.shape)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth per sample (ref ``vision_transformer.py:56-75``):
    ``dropout`` with one draw per leading index.  Nothing calls it."""
    return _drop(x, rate, generator, (x.shape[0],) + (1,) * (x.dim() - 1))


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
