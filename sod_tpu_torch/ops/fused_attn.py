"""Gridded attention half of a ViT block K5, inference only, as a
hand-written CUDA kernel chain.

Port of ``sod_tpu/ops/fused_attn.py``'s large-N pipeline (the Pallas
kernels ``_ln_qkv_kernel``, ``_attn_proj_kernel`` and
``_attn_proj_masked_kernel``, launched by ``_fwd_pallas_large``; entry
``fused_ln_attn_infer``): x + proj(MHSA(LN1(x))) on bf16 tokens padded to
a multiple of 128, at any token count.  The kernel is
``sod_tpu_torch/csrc/fused_attn.cu``; its header says how it is laid out.
Its rounding points differ from K1's attention half: qkv and the output
are bf16.

``fused_ln_attn_infer`` launches the kernel for a CUDA tensor and raises if
the build or the launch fails; the plain version
``fused_ln_attn_infer_reference`` runs only for a tensor on the CPU.  The
training pair of this file in ``sod_tpu`` (K3, ``fused_ln_attn``) is not
ported here.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional

import torch

from sod_tpu_torch.ops.fused_block import check_tokens
from sod_tpu_torch.ops.layers import layer_norm

launches = 0                   # kernel-chain launches, one per call
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fused_attn.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_attn").sod_fused_ln_attn_infer
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def _weights(block) -> List[torch.Tensor]:
    """LN1, qkv and proj of a ``models.vit.Block``, torch (out, in) layout."""
    return [block.norm1.weight, block.norm1.bias, block.attn.qkv.weight,
            block.attn.qkv.bias, block.attn.proj.weight, block.attn.proj.bias]


def fused_ln_attn_infer(x: torch.Tensor, block, n_heads: int, n_real: int,
                        key_mask: Optional[torch.Tensor] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    """x + proj(MHSA(LN1(x))) over padded tokens x [B, n_pad, D] (bf16).

    :param block: a ``models.vit.Block``; its weights are used as bf16.
    :param n_real: keys at index >= n_real (padding) are excluded.
    :param key_mask: optional [B, n_pad] bool, False keys excluded too.
    """
    check_tokens(x, block, n_heads, n_real, key_mask)
    if x.device.type == "cpu":
        return fused_ln_attn_infer_reference(x, block, n_heads, n_real,
                                             key_mask, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused attention for device {x.device}")
    b, n, d = x.shape
    weights = [w.to(device=x.device, dtype=torch.bfloat16).contiguous()
               for w in _weights(block)]
    mask = (None if key_mask is None
            else key_mask.to(device=x.device, dtype=torch.uint8).contiguous())
    qkv = torch.empty(b, n, 3 * d, device=x.device, dtype=torch.bfloat16)
    attn = torch.empty(b, n, d, device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    tensors = [x, *weights, mask, qkv, attn, out]
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused attention tensors must be 16-byte aligned")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        rc = _kernel()(*ptrs, b, n, d, n_heads, n_real, eps,
                       (d // n_heads) ** -0.5,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_attn_infer launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return out


def fused_ln_attn_infer_reference(x: torch.Tensor, block, n_heads: int,
                                  n_real: int,
                                  key_mask: Optional[torch.Tensor] = None,
                                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with K5's rounding points.

    Weights are rounded to bf16 and every product runs on f32 copies of
    bf16 values.  Rounded to bf16: LN1's output, qkv, the normalised
    probabilities, each head's p.v, and the output x + attn.Wproj + b.
    One head at a time, so the f32 scores of a canvas batch stay small."""
    bf16 = torch.bfloat16
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = (
        w.to(device=x.device, dtype=bf16).float() for w in _weights(block))
    b, n, d = x.shape
    hd = d // n_heads

    x0 = x.float()
    h = layer_norm(x0, ln_w, ln_b, eps).to(bf16).float()
    qkv = (torch.matmul(h, wqkv.t()) + bqkv).to(bf16).float()
    key_ok = torch.arange(n, device=x.device) < n_real
    key_ok = key_ok[None, :].expand(b, n)
    if key_mask is not None:
        key_ok = key_ok & key_mask.to(device=x.device, dtype=torch.bool)
    heads = []
    for i in range(n_heads):
        q, k, v = (qkv[..., j * d + i * hd:j * d + (i + 1) * hd] for j in range(3))
        s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        s = torch.where(key_ok[:, None, :], s, torch.full_like(s, -1e30))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        heads.append(torch.matmul(p.to(bf16).float(), v).to(bf16).float())
    attn = torch.cat(heads, dim=-1)
    return (x0 + torch.matmul(attn, wproj.t()) + bproj).to(x.dtype)
