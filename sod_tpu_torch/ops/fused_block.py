"""Whole pre-norm ViT encoder block as one hand-written CUDA kernel chain.

Port of ``sod_tpu/ops/fused_block.py`` (the Pallas kernel K1 and its
masked variant): LN1 -> QKV -> per-head softmax attention over the real
keys -> proj + residual -> LN2 -> fc1 -> tanh-GELU -> fc2 + residual, on
tokens padded to a multiple of 128.  The kernel is
``sod_tpu_torch/csrc/fused_block.cu``; its header says how it is laid out
on the card.

``fused_vit_block`` launches the kernel for a CUDA tensor and raises if
the build or the launch fails; it runs the plain version
``fused_vit_block_reference`` only for a tensor on the CPU.  Both keep
K1's rounding points (see ``fused_vit_block_reference``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional

import torch

from sod_tpu_torch.ops.layers import layer_norm

HEAD_DIMS = (32, 64, 128)      # head widths the CUDA attention is built for
MAX_DIM = 1024                 # LN rows of one 64-row tile fit shared memory

launches = 0                   # kernel-chain launches, one per block call
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fused_block.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_block").sod_fused_vit_block
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def _block_weights(block) -> List[torch.Tensor]:
    """The 12 tensors of a ``models.vit.Block`` in the kernel's order,
    torch (out, in) layout."""
    return [block.norm1.weight, block.norm1.bias,
            block.attn.qkv.weight, block.attn.qkv.bias,
            block.attn.proj.weight, block.attn.proj.bias,
            block.norm2.weight, block.norm2.bias,
            block.mlp.fc1.weight, block.mlp.fc1.bias,
            block.mlp.fc2.weight, block.mlp.fc2.bias]


def check_tokens(x: torch.Tensor, block, n_heads: int, n_real: int,
                 key_mask: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` for tokens the block kernels (K1, K5) do not
    take: [B, n_pad, D] contiguous bf16, n_pad % 128 == 0, a width and head
    dim they are built for, 0 < n_real <= n_pad, a [B, n_pad] key mask."""
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be [B, n_pad, D] bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, n, d = x.shape
    if n % 128:
        raise ValueError(f"pad tokens to a multiple of 128, got {n}")
    if d % 64 or d > MAX_DIM or d % n_heads or d // n_heads not in HEAD_DIMS:
        raise ValueError(f"unsupported width: d={d}, n_heads={n_heads} "
                         f"(need d % 64 == 0, d <= {MAX_DIM}, head dim in "
                         f"{HEAD_DIMS})")
    if block.mlp.fc1.weight.shape[0] % 64:
        raise ValueError("MLP hidden width must be a multiple of 64")
    if not 0 < n_real <= n:
        raise ValueError(f"n_real={n_real} outside (0, {n}]")
    if key_mask is not None and tuple(key_mask.shape) != (b, n):
        raise ValueError(f"key_mask must be [{b}, {n}], got "
                         f"{tuple(key_mask.shape)}")


def fused_vit_block(x: torch.Tensor, block, n_heads: int, n_real: int,
                    key_mask: Optional[torch.Tensor] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """Apply one encoder block to padded tokens x [B, n_pad, D] (bf16).

    :param block: a ``models.vit.Block``; its weights are used as bf16.
    :param n_real: keys at index >= n_real (padding) are excluded.
    :param key_mask: optional [B, n_pad] bool, False keys excluded too.
    """
    check_tokens(x, block, n_heads, n_real, key_mask)
    if x.device.type == "cpu":
        return fused_vit_block_reference(x, block, n_heads, n_real,
                                         key_mask, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused block for device {x.device}")

    b, n, d = x.shape
    weights = [w.to(device=x.device, dtype=torch.bfloat16).contiguous()
               for w in _block_weights(block)]
    hidden = weights[8].shape[0]
    mask = (None if key_mask is None
            else key_mask.to(device=x.device, dtype=torch.uint8).contiguous())
    qkv = torch.empty(b, n, 3 * d, device=x.device, dtype=torch.bfloat16)
    attn = torch.empty(b, n, d, device=x.device, dtype=torch.bfloat16)
    x1 = torch.empty(b, n, d, device=x.device, dtype=torch.float32)
    hid = torch.empty(b, n, hidden, device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    tensors = [x, *weights, mask, qkv, attn, x1, hid, out]
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused block tensors must be 16-byte aligned")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        rc = _kernel()(*ptrs, b, n, d, n_heads, hidden, n_real, eps,
                       (d // n_heads) ** -0.5,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vit_block launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return out


def fused_vit_block_reference(x: torch.Tensor, block, n_heads: int,
                              n_real: int,
                              key_mask: Optional[torch.Tensor] = None,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with K1's rounding points.

    Weights are rounded to bf16 and every product runs on f32 copies of
    bf16 values (= bf16 x bf16 with f32 accumulation).  Rounded to bf16:
    LN1 and LN2 outputs, qkv, the normalised probabilities, each head's
    p.v, the GELU output, the block output.  x1 = x + attn.Wproj + b stays
    f32.  GELU is the tanh form with K1's constants."""
    bf16 = torch.bfloat16
    (ln1w, ln1b, wqkv, bqkv, wproj, bproj, ln2w, ln2b, w1, b1, w2,
     b2) = (w.to(device=x.device, dtype=bf16).float()
            for w in _block_weights(block))
    b, n, d = x.shape
    hd = d // n_heads

    x0 = x.float()
    h = layer_norm(x0, ln1w, ln1b, eps).to(bf16).float()
    qkv = (torch.matmul(h, wqkv.t()) + bqkv).to(bf16).float()
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, n_heads, hd)
               .transpose(1, 2) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    key_ok = torch.arange(n, device=x.device) < n_real
    key_ok = key_ok[None, :].expand(b, n)
    if key_mask is not None:
        key_ok = key_ok & key_mask.to(device=x.device, dtype=torch.bool)
    s = torch.where(key_ok[:, None, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    attn = torch.matmul(p.to(bf16).float(), v).to(bf16).float()
    attn = attn.transpose(1, 2).reshape(b, n, d)

    x1 = x0 + torch.matmul(attn, wproj.t()) + bproj
    h2 = layer_norm(x1, ln2w, ln2b, eps).to(bf16).float()
    hid = torch.matmul(h2, w1.t()) + b1
    hid = (0.5 * hid * (1.0 + torch.tanh(
        0.7978845608028654 * (hid + 0.044715 * hid ** 3)))).to(bf16).float()
    out = torch.matmul(hid, w2.t())
    return (x1 + out + b2).to(x.dtype)
