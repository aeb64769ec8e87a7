"""Flash attention K2, forward and backward, as hand-written CUDA kernels.

Port of ``sod_tpu/ops/flash_attention.py``: ``flash_attention(q, k, v,
scale, key_mask=None)`` computes softmax(q k^T * scale) v over [B, H, N, d]
with an optional [B, N] key mask, as a ``torch.autograd.Function``.  The
kernels are ``sod_tpu_torch/csrc/flash_attention.cu`` (its header says how
they are laid out on the card):

* forward, one launch: ``_fwd_kernel`` / ``_fwd_kernel_masked``'s math
  (two passes over the keys, so p is rounded after normalising); it also
  keeps each row's softmax max and sum (f32 [B, H, N]) for the backward;
* backward without a key mask, two launches per call: ``_bwd_kernel``'s
  math, tiled (a dq launch that also writes D = sum(p * dp), then a dk/dv
  launch); ``bwd_launches`` counts calls, not launches;
* backward with a key mask: ``sod_tpu`` has no kernel there and runs XLA
  (``_bwd``, ``flash_attention.py:262-286``); the port runs the plain twin
  of that branch, ``flash_backward_masked_reference``.  Training never has
  a key mask.

All three launches keep their 64 x 64 score tiles in the tensor cores'
accumulator registers (``wgmma``), do the softmax arithmetic there and feed
bf16 p and ds to the next product from registers; K, V (backward: Q, dO)
tiles arrive through a two-stage ``cp.async`` ring.  No atomics: two calls
on the same inputs give equal bits.  ``scale`` must be positive (the row max
is taken before scaling).

For a CUDA tensor the wrappers launch the kernels or raise (build, launch
return code, shapes); the plain versions ``flash_forward_reference`` and
``flash_backward_reference`` run only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

HEAD_DIMS = (32, 64, 128)      # head widths the CUDA kernels are built for

fwd_launches = 0               # forward kernel launches
bwd_launches = 0               # backward calls (each a dq and a dk/dv launch)
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of ``csrc/flash_attention.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    lib = load("flash_attention")
    fwd, bwd = lib.sod_flash_forward, lib.sod_flash_backward
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    return fwd, bwd


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_mask: Optional[torch.Tensor]) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, H, N, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] < 1:
        raise ValueError("no tokens")
    if key_mask is not None and tuple(key_mask.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(f"key_mask must be [{q.shape[0]}, {q.shape[2]}], got "
                         f"{tuple(key_mask.shape)}")


def _check_cuda(*tensors: torch.Tensor) -> None:
    """What the kernels take: contiguous, 16-byte aligned bf16 CUDA tensors
    with a head dim the kernels are built for."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention tensors must be contiguous, "
                             "16-byte aligned and on one device")


def _count(kind: str) -> None:
    global fwd_launches, bwd_launches
    with _launch_lock:
        if kind == "fwd":
            fwd_launches += 1
        else:
            bwd_launches += 1


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, key_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (o, row max, row sum)."""
    _check(q, k, v, key_mask)
    _check_cuda(q, k, v)
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    b, h, n, d = q.shape
    mask = (None if key_mask is None
            else key_mask.to(device=q.device, dtype=torch.uint8).contiguous())
    o = torch.empty_like(q)
    m = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    ptrs = [t.data_ptr() for t in (q, k, v)] + [
        None if mask is None else mask.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr()]
    with torch.cuda.device(q.device):
        rc = _kernels()[0](*ptrs, b, h, n, d, scale,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed: cudaError {rc}")
    _count("fwd")
    return o, m, l


def flash_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (no key mask) from the forward's row max
    ``m`` and sum ``l``: (dq, dk, dv)."""
    _check(q, k, v, None)
    do = do.to(q.dtype).contiguous()          # sod_tpu casts g (:198)
    _check_cuda(q, k, v, do, m, l)
    b, h, n, d = q.shape
    if m.dtype != torch.float32 or tuple(m.shape) != (b, h, n) \
            or l.dtype != torch.float32 or l.shape != m.shape:
        raise ValueError("m and l must be the forward's f32 [B, H, N] residuals")
    dsum = torch.empty_like(m)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ptrs = [t.data_ptr() for t in (q, k, v, do, m, l, dsum, dq, dk, dv)]
    with torch.cuda.device(q.device):
        rc = _kernels()[1](*ptrs, b, h, n, d, scale,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: cudaError {rc}")
    _count("bwd")
    return dq, dk, dv


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float,
           key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 softmax(q k^T * scale) with masked keys at -1e30 (e / sum)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask.bool()[:, None, None, :], s,
                        torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float,
                            key_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of ``_fwd_kernel`` / ``_fwd_kernel_masked``: f32
    logits and softmax, p rounded to ``v.dtype`` after normalising, p.v
    accumulated in f32 and cast back.  (The Pallas kernel's padded keys sit
    at -1e30 and add exactly zero, so no padding is needed here.)"""
    p = _probs(q, k, scale, key_mask)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_bwd_kernel`` (``flash_attention.py:145-179``):
    p recomputed in f32; dv = p_c^T do, dp = do v^T, ds = p (dp - sum(dp p))
    * scale, dq = ds_c k, dk = ds_c^T q, with ``_c`` the cast to q's dtype
    and every product accumulated in f32."""
    dt = q.dtype
    do = do.to(dt).float()
    p = _probs(q, k, scale, None)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dsc = ds.to(dt).float()
    dq = torch.matmul(dsc, k.float())
    dk = torch.matmul(dsc.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_backward_masked_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, do: torch.Tensor,
                                    scale: float, key_mask: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_bwd``'s XLA branch (``flash_attention.py:266-286``),
    the one ``sod_tpu`` runs under a key mask: as the kernel, but scale is
    applied after the dq and dk products instead of inside ds."""
    dt = q.dtype
    p = _probs(q, k, scale, key_mask)
    g = do.to(dt).float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    dsc = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(dsc, k.float()) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, key_mask):
        _check(q, k, v, key_mask)
        if q.device.type == "cpu":
            o = flash_forward_reference(q, k, v, scale, key_mask)
            stats = ()
        elif q.device.type == "cuda":
            o, m, l = flash_forward_cuda(q, k, v, scale, key_mask)
            stats = (m, l)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.scale = scale
        ctx.masked = key_mask is not None
        ctx.save_for_backward(q, k, v, *stats,
                              *(() if key_mask is None else (key_mask,)))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *rest = ctx.saved_tensors
        if ctx.masked:
            # sod_tpu's XLA branch under a key mask: no kernel on either side
            dq, dk, dv = flash_backward_masked_reference(q, k, v, do, ctx.scale,
                                                         rest[-1])
        elif q.device.type == "cpu":
            dq, dk, dv = flash_backward_reference(q, k, v, do, ctx.scale)
        else:
            dq, dk, dv = flash_backward_cuda(q, k, v, do, *rest, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, N, d], optional key mask [B, N]
    (False keys excluded; keep at least one valid key per image)."""
    return _FlashAttention.apply(q, k, v, scale, key_mask)
