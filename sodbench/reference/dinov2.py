"""Plain PyTorch reference of SelfMask nq20 on DINOv2's ViT-g/14 with
registers (``dinov2_vitg14_reg``).

The encoder as published (github.com/facebookresearch/dinov2,
``dinov2/hub/backbones.py`` ``dinov2_vitg14_reg``: ``vit_giant2`` with
``num_register_tokens=4``, ``init_values=1.0``, ``ffn_layer="swiglufused"``,
``interpolate_antialias=True``, ``interpolate_offset=0.0``): the patch
convolution, CLS, the position table (bicubic with antialiasing at another
grid), the registers after CLS with no position, pre-norm blocks
``x + ls1(attn(norm1(x)))`` then ``x + ls2(w3(silu(x1) * x2))`` with
``x1, x2 = w12(x).chunk(2)``, the final LayerNorm.  The decoder reads the
patch tokens (CLS and registers dropped) through the channel adapter
``linear_layer`` (1536 -> 384), then SelfMask's decoder and heads as
``reference/model.py`` has them.

Departures from the published code, none of which changes a number:

* each block runs under ``torch.utils.checkpoint`` (its backward computes
  it again), so that B=8 at 518 px fits the card in f32;
* attention is the plain softmax (DINOv2's ``MemEffAttention`` is xformers'
  memory-efficient kernel of the same math), the SwiGLU the xformers-free
  ``SwiGLUFFN`` of the same math;
* ``mask_token`` is left out: only masked pretraining reads it.

``param_specs`` draws DINOv2's ``init_weights``: linears N(0, 0.02) clipped
at +-2 with zero biases, LayerNorms ones and zeros, the position table
N(0, 0.02), the patch convolution torch's default; two departures, so that
every leaf's gradient is large enough for the check to see: the LayerScale
gammas are the hub's ``init_values`` 1 (pretraining starts them at 1e-5,
every block then near the identity), and CLS and the registers are drawn
like the position table (DINOv2: std 1e-6).

Arithmetic and ``Arith`` as in ``reference/model.py``: f32 with TF32 off,
or ``fp8`` where the program keeps bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sodbench.reference.model import (VIT_LN_EPS, Arith, _heads, _linear_spec, _merge,
                                      _norm_spec, attention, decoder_forward, heads,
                                      is_buffer, layer_norm, normalize, param_specs as
                                      selfmask_specs, upsample_tokens)
from sodbench.reference.train import criterion, poly_lr

HEAD_DIM = 64                   # DINOv2's heads are 64 wide at every size
# dinov2_vitg14_reg: width, depth, patch, the 518 px position grid, registers
VITG14_REG = {"d": 1536, "depth": 40, "patch": 14, "pos_grid": 37, "n_registers": 4}


def swiglu_hidden(d: int) -> int:
    """``SwiGLUFFNFused``'s hidden width for ``mlp_ratio`` 4."""
    return (int(4 * d * 2 / 3) + 7) // 8 * 8


def encoder_specs(d: int, depth: int, patch: int, pos_grid: int,
                  n_registers: int) -> List[Tuple]:
    """The encoder's tensors under the hub's names (``encoder.`` prefixed)."""
    bound = 1.0 / math.sqrt(3 * patch * patch)     # torch's default Conv2d init
    hidden = swiglu_hidden(d)
    out = [("encoder.cls_token", (1, 1, d), "normal", 0.02),
           ("encoder.pos_embed", (1, pos_grid * pos_grid + 1, d), "normal", 0.02),
           ("encoder.register_tokens", (1, n_registers, d), "normal", 0.02),
           ("encoder.patch_embed.proj.weight", (d, 3, patch, patch), "uniform", bound),
           ("encoder.patch_embed.proj.bias", (d,), "uniform", bound)]
    for i in range(depth):
        pre = f"encoder.blocks.{i}"
        out += _norm_spec(f"{pre}.norm1", d)
        out += _linear_spec(f"{pre}.attn.qkv", d, 3 * d, "trunc")
        out += _linear_spec(f"{pre}.attn.proj", d, d, "trunc")
        out.append((f"{pre}.ls1.gamma", (d,), "ones", 0.0))
        out += _norm_spec(f"{pre}.norm2", d)
        out += _linear_spec(f"{pre}.mlp.w12", d, 2 * hidden, "trunc")
        out += _linear_spec(f"{pre}.mlp.w3", hidden, d, "trunc")
        out.append((f"{pre}.ls2.gamma", (d,), "ones", 0.0))
    return out + _norm_spec("encoder.norm", d)


def param_specs(d: int = 1536, depth: int = 40, patch: int = 14, pos_grid: int = 37,
                n_registers: int = 4, n_queries: int = 20, n_decoder_layers: int = 6,
                d_decoder: int = 384) -> List[Tuple]:
    """[(name, shape, init, scale)] of the whole model (``make_weights``
    draws them): the encoder, the adapter (torch's default Linear init), and
    ``reference/model.py``'s decoder, queries and heads."""
    decoder = [s for s in selfmask_specs("vit_small", 8, n_queries, n_decoder_layers, d_decoder)
               if not s[0].startswith("encoder.")]
    return (encoder_specs(d, depth, patch, pos_grid, n_registers)
            + _linear_spec("linear_layer", d, d_decoder, "default") + decoder)


def pos_embed_for(P, gh: int, gw: int) -> torch.Tensor:
    """The [1, 1 + gh gw, D] position table of a (gh, gw) grid: the learned
    table, or its patch part resized bicubic with antialiasing to the grid's
    size (``interpolate_pos_encoding``, no offset)."""
    pe = P["encoder.pos_embed"]
    g = int(round(math.sqrt(pe.shape[1] - 1)))
    if (gh, gw) == (g, g):
        return pe
    d = pe.shape[-1]
    grid = pe[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True,
                         align_corners=False)
    return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], 1)


def _block(P, ar: Arith, i: int, t: torch.Tensor) -> torch.Tensor:
    pre = f"encoder.blocks.{i}."

    def norm(name, z):
        return ar.act(layer_norm(z, P[name + ".weight"], P[name + ".bias"], VIT_LN_EPS))

    def lin(name, z):
        return ar.linear(z, P[pre + name + ".weight"], P[pre + name + ".bias"])

    qkv = lin("attn.qkv", norm(pre + "norm1", t))
    q, k, v = (_heads(z, t.shape[-1] // HEAD_DIM) for z in qkv.chunk(3, dim=-1))
    o = _merge(attention(ar, q, k, v))
    t = ar.act(t + ar.act(lin("attn.proj", o) * P[pre + "ls1.gamma"]))
    x1, x2 = lin("mlp.w12", norm(pre + "norm2", t)).chunk(2, dim=-1)
    h = ar.act(ar.act(F.silu(x1)) * x2)
    return ar.act(t + ar.act(lin("mlp.w3", h) * P[pre + "ls2.gamma"]))


def encoder_forward(P, ar: Arith, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """x [B, H, W, 3] normalised (H, W multiples of the patch) -> the final
    LayerNorm of every token [B, 1 + R + N, D] (CLS, registers, patches) and
    the patch grid."""
    w = P["encoder.patch_embed.proj.weight"]
    p = w.shape[-1]
    t = ar.act(ar.conv(ar.act(x).permute(0, 3, 1, 2), w, stride=p)
               + P["encoder.patch_embed.proj.bias"][:, None, None])
    b, d, gh, gw = t.shape
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([P["encoder.cls_token"].expand(b, 1, d), t], 1)
    t = ar.act(t + pos_embed_for(P, gh, gw))
    regs = ar.act(P["encoder.register_tokens"]).expand(b, -1, d)
    t = torch.cat([t[:, :1], regs, t[:, 1:]], 1)
    depth = sum(1 for k in P if k.startswith("encoder.blocks.") and k.endswith(".ls1.gamma"))
    for i in range(depth):
        t = checkpoint(lambda z, i=i: _block(P, ar, i, z), t, use_reentrant=False)
    n = P["encoder.norm.weight"]
    return ar.act(layer_norm(t, n, P["encoder.norm.bias"], VIT_LN_EPS)), (gh, gw)


def forward(P, u8: torch.Tensor, ar: Arith = None) -> Dict[str, torch.Tensor]:
    """The whole model on uint8 images [B, H, W, 3] (H, W multiples of 14)."""
    ar = ar or Arith()
    tokens, grid = encoder_forward(P, ar, normalize(u8))
    skip = 1 + P["encoder.register_tokens"].shape[1]
    memory = ar.linear(tokens[:, skip:], P["linear_layer.weight"], P["linear_layer.bias"])
    queries = decoder_forward(P, ar, memory)
    return heads(P, queries, ar.act(upsample_tokens(memory, grid)))


def train_steps(P: Dict[str, torch.Tensor], batches: Sequence[dict], cfg: dict,
                total_iters: int, ar: Arith = None,
                keep_rows: float = 1.0) -> Dict[str, object]:
    """``reference/train.py``'s ``train_steps`` on this model: each step's
    loss, the first step's clipped gradient per leaf and the parameters after
    the last step, from weights ``P`` (not changed); ``keep_rows`` < 1 keeps
    only each batch's first rows (the half-batch fault)."""
    ar = ar or Arith()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in P.items() if not is_buffer(k)}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, cfg["weight_decay"]
    losses: List[float] = []
    first_grad = None
    names = list(params)
    for step, batch in enumerate(batches):
        if keep_rows < 1.0:
            rows = max(1, int(batch["image"].shape[0] * keep_rows))
            batch = {k: v[:rows] for k, v in batch.items()}
        out = forward(params, batch["image"], ar)
        loss = criterion(out, batch, cfg["weight_contrastive_loss"], cfg["temperature"])
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        del out
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
            scale = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
            for g in grads:
                g.mul_(scale)
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(names, grads)}
            lr = poly_lr(cfg["lr"], step, total_iters)
            t = step + 1
            for k, g in zip(names, grads):
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                params[k].sub_(lr * (upd + wd * params[k]))
        del grads
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in params.items()}}
