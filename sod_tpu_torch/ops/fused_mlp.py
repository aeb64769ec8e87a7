"""MLP half of a ViT block K4, forward only, as a hand-written CUDA kernel
chain.

Port of the forward of ``sod_tpu/ops/fused_mlp.py`` (the Pallas kernel
``_kernel``, launched by ``_rows_pallas``; entry ``fused_ln_mlp``):
x + fc2(tanh-GELU(fc1(LN2(x)))) on bf16 rows, any row count.  The kernel
is ``sod_tpu_torch/csrc/fused_mlp.cu``.  It reads bf16 x (K1's MLP half
reads its f32 x1), rounds the hidden to bf16 after the GELU and the output
(x + y + b2, in f32) to bf16.

``fused_ln_mlp`` launches the kernel for a CUDA tensor and raises if the
build or the launch fails, and for a CUDA tensor that requires grad: the
backward (``_bwd_kernel``) and ``_kernel_save`` are not ported, and a
forward without its gradient is not offered.  The plain version
``fused_ln_mlp_reference`` runs only for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List

import torch
import torch.nn.functional as F

from sod_tpu_torch.ops.fused_block import MAX_DIM
from sod_tpu_torch.ops.layers import layer_norm

ROWS = 64                      # the kernel's row tile: rows are padded to it

launches = 0                   # kernel-chain launches, one per call
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fused_mlp.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_mlp").sod_fused_ln_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _weights(block) -> List[torch.Tensor]:
    """LN2, fc1 and fc2 of a ``models.vit.Block``, torch (out, in) layout."""
    return [block.norm2.weight, block.norm2.bias, block.mlp.fc1.weight,
            block.mlp.fc1.bias, block.mlp.fc2.weight, block.mlp.fc2.bias]


def fused_ln_mlp(x: torch.Tensor, block, eps: float = 1e-6) -> torch.Tensor:
    """x + MLP(LN2(x)) over bf16 tokens x [..., D] (rows are independent).

    :param block: a ``models.vit.Block``; its weights are used as bf16.
    """
    if x.dtype != torch.bfloat16 or x.dim() < 2:
        raise ValueError(f"x must be [..., D] bfloat16, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    hidden = block.mlp.fc1.weight.shape[0]
    if d % 64 or d > MAX_DIM or hidden % 64:
        raise ValueError(f"unsupported widths d={d}, hidden={hidden} (need "
                         f"multiples of 64, d <= {MAX_DIM})")
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, block, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused MLP for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in _weights(block))):
        raise NotImplementedError(
            "fused_ln_mlp on the card is forward only: its backward is K4's "
            "backward kernels, queued with K3 (ROADMAP §2, the "
            "use_fused_train / use_fused_mlp training slice)")
    rows = x.numel() // d
    x2d = x.reshape(rows, d)
    pad = -rows % ROWS
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad))
    x2d = x2d.contiguous()
    weights = [w.to(device=x.device, dtype=torch.bfloat16).contiguous()
               for w in _weights(block)]
    hid = torch.empty(x2d.shape[0], hidden, device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x2d)
    tensors = [x2d, *weights, hid, out]
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused MLP tensors must be 16-byte aligned")
    with torch.cuda.device(x.device):
        rc = _kernel()(*(t.data_ptr() for t in tensors), x2d.shape[0], d, hidden,
                       eps, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_mlp launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return out[:rows].reshape(x.shape)


def fused_ln_mlp_reference(x: torch.Tensor, block,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with K4's rounding points:
    weights rounded to bf16, products on f32 copies of bf16 values, LN2's
    output and the tanh-GELU hidden rounded to bf16, x + y + b2 in f32
    rounded once to ``x.dtype``."""
    bf16 = torch.bfloat16
    ln_w, ln_b, w1, b1, w2, b2 = (w.to(device=x.device, dtype=bf16).float()
                                  for w in _weights(block))
    x0 = x.float()
    h = layer_norm(x0, ln_w, ln_b, eps).to(bf16).float()
    a = torch.matmul(h, w1.t()) + b1
    g = (0.5 * a * (1.0 + torch.tanh(
        0.7978845608028654 * (a + 0.044715 * a ** 3)))).to(bf16).float()
    return (x0 + torch.matmul(g, w2.t()) + b2).to(x.dtype)
