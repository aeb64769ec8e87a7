"""MLP half of a ViT block K4, forward and backward, as hand-written CUDA
kernel chains.

Port of ``sod_tpu/ops/fused_mlp.py`` (the Pallas kernels ``_kernel`` and
``_kernel_save``, launched by ``_rows_pallas``, and ``_bwd_kernel`` and
``_bwd_kernel_saved``, launched by ``_bwd_pallas``; entry ``fused_ln_mlp``):
x + fc2(tanh-GELU(fc1(LN2(x)))) on bf16 rows, any row count, as a
``torch.autograd.Function``.  The kernels are
``sod_tpu_torch/csrc/fused_mlp.cu``; its header says how they are laid out.
The forward reads bf16 x (K1's MLP half reads its f32 x1), rounds the hidden
to bf16 after the GELU and the output (x + y + b2, in f32) to bf16.  The
backward recomputes LN2 and the pre-GELU hidden ``a`` (f32), or, under
``save_acts``, reads the bf16 ``a`` that the forward kept and evaluates the
GELU and its gradient on that rounded value, as ``_bwd_kernel_saved`` does.

Gradients: dx in x's dtype.  ``sod_tpu`` hands this op bf16 copies of its
parameters (``_prep_weights``), so its weight gradients are rounded to bf16
on the way back to the f32 master weights; the port does the same: the f32
sums of the kernel are rounded to bf16, then cast to each parameter's dtype,
in torch's (out, in) layout.

For a CUDA tensor the wrapper launches the kernels or raises (build, launch
return code, shapes, a dtype other than bf16); the plain versions
``fused_ln_mlp_reference`` and ``fused_ln_mlp_backward_reference`` run only
for a tensor on the CPU, where x may also be f32 (``sod_tpu``'s twin keeps
x's dtype and always rounds the matmul inputs to bf16).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sod_tpu_torch.ops.fused_block import MAX_DIM
from sod_tpu_torch.ops.layers import layer_norm

ROWS = 64                      # the kernel's row tile: rows are padded to it

launches = 0                   # forward kernel-chain launches, one per call
save_launches = 0              # those of them that also wrote the hidden
bwd_launches = 0               # backward kernel-chain launches, one per call
_launch_lock = threading.Lock()

_C0 = 0.7978845608028654       # sqrt(2 / pi)
_C1 = 0.044715


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of ``csrc/fused_mlp.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    lib = load("fused_mlp")
    fwd, bwd = lib.sod_fused_ln_mlp, lib.sod_fused_ln_mlp_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_void_p])
    scratch = lib.sod_fused_ln_mlp_bwd_scratch
    scratch.restype = None
    scratch.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    return fwd, bwd, scratch


def bwd_scratch_floats(rows: int, d: int, hidden: int) -> Tuple[int, int]:
    """f32 elements of the backward's partial buffers at ``rows`` rows:
    (the weight gradients' row splits, the LayerNorm backward's blocks), as
    the kernels' plan gives them."""
    out = (ctypes.c_longlong * 2)()
    _kernels()[2](rows, d, hidden, out)
    return out[0], out[1]


def _weights(block) -> List[torch.Tensor]:
    """LN2, fc1 and fc2 of a ``models.vit.Block``, torch (out, in) layout."""
    return [block.norm2.weight, block.norm2.bias, block.mlp.fc1.weight,
            block.mlp.fc1.bias, block.mlp.fc2.weight, block.mlp.fc2.bias]


def _bf16_weights(weights: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    return [w.detach().to(device=device, dtype=torch.bfloat16).contiguous()
            for w in weights]


def check_aligned(tensors, what: str = "fused MLP") -> None:
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} tensors must be 16-byte aligned")


def _count(kind: str) -> None:
    global launches, save_launches, bwd_launches
    with _launch_lock:
        if kind == "bwd":
            bwd_launches += 1
        else:
            launches += 1
            save_launches += kind == "save"


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * a * (1.0 + torch.tanh(_C0 * (a + _C1 * a ** 3)))


def _gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_C0 * (a + _C1 * a ** 3))
    da = _C0 * (1.0 + 3.0 * _C1 * a ** 2)
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t ** 2) * da


def _ln_pieces(x0: torch.Tensor, ln_w: torch.Tensor, eps: float):
    """xhat and 1 / sqrt(var + eps) of f32 rows."""
    mean = x0.mean(dim=-1, keepdim=True)
    var = ((x0 - mean) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x0 - mean) * inv, inv


def ln_backward_reference(dh: torch.Tensor, xhat: torch.Tensor,
                          inv: torch.Tensor, ln_w: torch.Tensor,
                          g: torch.Tensor):
    """LayerNorm backward + residual shared by K3 and K4 (f32 rows):
    (dx, dLN scale, dLN bias, column sums of g)."""
    dxhat = dh * ln_w
    dx = g + inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, (dh * xhat).sum(dim=0), dh.sum(dim=0), g.sum(dim=0)


def forward_cuda(x2d: torch.Tensor, weights: Sequence[torch.Tensor],
                 eps: float, want_hidden: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward chain on bf16 rows [R, D], R % 64 == 0: the
    output and, with ``want_hidden``, the bf16 pre-GELU hidden [R, hidden]."""
    rows, d = x2d.shape
    hidden = weights[2].shape[0]
    hid = torch.empty(rows, hidden, device=x2d.device, dtype=torch.bfloat16)
    a = torch.empty_like(hid) if want_hidden else None
    out = torch.empty_like(x2d)
    tensors = [x2d, *weights, hid, a, out]
    check_aligned(tensors)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x2d.device):
        rc = _kernels()[0](*ptrs, rows, d, hidden, eps,
                           torch.cuda.current_stream(x2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_mlp launch failed: cudaError {rc}")
    _count("save" if want_hidden else "fwd")
    return out, a


def backward_cuda(x2d: torch.Tensor, dy: torch.Tensor,
                  weights: Sequence[torch.Tensor], eps: float,
                  a_saved: Optional[torch.Tensor] = None):
    """Launch the backward chain on bf16 rows [R, D], R % 64 == 0:
    (dx bf16, then f32 dLN scale, dLN bias, dW1 (hidden, D), db1, dW2
    (D, hidden), db2).  ``a_saved``: the forward's bf16 hidden, or None to
    recompute it."""
    rows, d = x2d.shape
    hidden = weights[2].shape[0]
    dev = x2d.device
    bf16, f32 = torch.bfloat16, torch.float32
    ln_w, ln_b, w1, b1, w2, _ = weights
    h = torch.empty(rows, d, device=dev, dtype=bf16)
    da = torch.empty(rows, hidden, device=dev, dtype=bf16)
    gel = torch.empty_like(da)
    dh = torch.empty(rows, d, device=dev, dtype=f32)
    part_b1 = torch.empty(rows // 64, hidden, device=dev, dtype=f32)
    n_w, n_ln = bwd_scratch_floats(rows, d, hidden)
    part_w = torch.empty(max(n_w, 1), device=dev, dtype=f32)
    part_ln = torch.empty(n_ln, device=dev, dtype=f32)
    dx = torch.empty_like(x2d)
    dw1 = torch.empty(hidden, d, device=dev, dtype=f32)
    db1 = torch.empty(hidden, device=dev, dtype=f32)
    dw2 = torch.empty(d, hidden, device=dev, dtype=f32)
    dln3 = torch.empty(3, d, device=dev, dtype=f32)
    tensors = [x2d, dy, a_saved, ln_w, ln_b, w1, b1, w2, h, da, gel, dh,
               part_b1, part_w, part_ln, dx, dw1, db1, dw2, dln3]
    check_aligned(tensors)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        rc = _kernels()[1](*ptrs, rows, d, hidden, eps,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_mlp backward launch failed: cudaError {rc}")
    _count("bwd")
    return dx, dln3[0], dln3[1], dw1, db1, dw2, dln3[2]


def _forward_plain(x2d: torch.Tensor, weights: Sequence[torch.Tensor],
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output in x's dtype, f32 pre-GELU hidden) with K4's rounding points."""
    bf16 = torch.bfloat16
    ln_w, ln_b, w1, b1, w2, b2 = (w.detach().to(device=x2d.device, dtype=bf16).float()
                                  for w in weights)
    x0 = x2d.float()
    h = layer_norm(x0, ln_w, ln_b, eps).to(bf16).float()
    a = torch.matmul(h, w1.t()) + b1
    g = _gelu_tanh(a).to(bf16).float()
    return (x0 + torch.matmul(g, w2.t()) + b2).to(x2d.dtype), a


def fused_ln_mlp_reference(x: torch.Tensor, block,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, with K4's rounding
    points: weights rounded to bf16, products on f32 copies of bf16 values,
    LN2's output and the tanh-GELU hidden rounded to bf16, x + y + b2 in f32
    rounded once to ``x.dtype``."""
    return _forward_plain(x, _weights(block), eps)[0]


def fused_ln_mlp_save_reference(x: torch.Tensor, block, eps: float = 1e-6
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``_kernel_save``: the output and bf16(a), the
    pre-GELU hidden (rounded from the f32 that feeds the GELU)."""
    out, a = _forward_plain(x, _weights(block), eps)
    return out, a.to(torch.bfloat16)


def fused_ln_mlp_backward_reference(x2d: torch.Tensor, dy: torch.Tensor,
                                    weights: Sequence[torch.Tensor],
                                    eps: float = 1e-6,
                                    a_saved: Optional[torch.Tensor] = None):
    """Plain version of ``_bwd_kernel`` (``a_saved`` None: the hidden is
    recomputed in f32) and ``_bwd_kernel_saved`` (``a_saved``: the forward's
    bf16 hidden; GELU and its gradient are evaluated on the rounded value).
    dy is rounded to x's dtype first (``_bwd_pallas``); every product runs
    on f32 copies of bf16 values.  Returns (dx in x's dtype, then f32 dLN
    scale, dLN bias, dW1 (hidden, D), db1, dW2 (D, hidden), db2)."""
    bf16 = torch.bfloat16
    ln_w, ln_b, w1, b1, w2, _ = (w.detach().to(device=x2d.device, dtype=bf16).float()
                                 for w in weights)
    x0 = x2d.float()
    dyf = dy.to(x2d.dtype).float()
    xhat, inv = _ln_pieces(x0, ln_w, eps)
    h = (xhat * ln_w + ln_b).to(bf16).float()
    a = (torch.matmul(h, w1.t()) + b1) if a_saved is None else a_saved.float()
    g = _gelu_tanh(a).to(bf16).float()
    dyc = dyf.to(bf16).float()
    dw2 = torch.matmul(dyc.t(), g)                       # (D, hidden)
    dg = torch.matmul(dyc, w2)
    da = dg * _gelu_tanh_grad(a)
    dac = da.to(bf16).float()
    dw1 = torch.matmul(dac.t(), h)                       # (hidden, D)
    db1 = da.sum(dim=0)
    dh = torch.matmul(dac, w1)
    dx, dls, dlb, db2 = ln_backward_reference(dh, xhat, inv, ln_w, dyf)
    return dx.to(x2d.dtype), dls, dlb, dw1, db1, dw2, db2


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> None:
    if x.dim() < 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be [..., D] bfloat16 (or float32 on the CPU), "
                         f"got {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    hidden = weights[2].shape[0]
    if d % 64 or d > MAX_DIM or hidden % 64:
        raise ValueError(f"unsupported widths d={d}, hidden={hidden} (need "
                         f"multiples of 64, d <= {MAX_DIM})")
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused MLP for device {x.device}")


def _pad_rows(x2d: torch.Tensor) -> torch.Tensor:
    pad = -x2d.shape[0] % ROWS
    return (F.pad(x2d, (0, 0, 0, pad)) if pad else x2d).contiguous()


class _FusedLnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, save_acts):
        weights = (ln_w, ln_b, w1, b1, w2, b2)
        _check(x, weights)
        d = x.shape[-1]
        x2d = x.reshape(-1, d)
        rows = x2d.shape[0]
        a = None
        if x.device.type == "cpu":
            out, a32 = _forward_plain(x2d, weights, eps)
            if save_acts:
                a = a32.to(torch.bfloat16)
            kept = weights
        else:
            x2d = _pad_rows(x2d)
            kept = _bf16_weights(weights, x.device)
            out, a = forward_cuda(x2d, kept, eps, bool(save_acts))
            out = out[:rows]
        ctx.eps, ctx.rows, ctx.shape = eps, rows, x.shape
        ctx.has_a = a is not None
        ctx.dtypes = [w.dtype for w in weights]
        ctx.save_for_backward(x2d, *kept, *(() if a is None else (a,)))
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, *rest = ctx.saved_tensors
        weights, a = (rest[:6], rest[6]) if ctx.has_a else (rest, None)
        d = x2d.shape[-1]
        dy2d = dy.reshape(-1, d).to(x2d.dtype)
        if x2d.device.type == "cpu":
            grads = fused_ln_mlp_backward_reference(x2d, dy2d, weights, ctx.eps, a)
        else:
            grads = backward_cuda(x2d, _pad_rows(dy2d), weights, ctx.eps, a)
        dx = grads[0][:ctx.rows].reshape(ctx.shape)
        # sod_tpu differentiates w.r.t. bf16 copies of the parameters: the
        # f32 sums are rounded to bf16 before they reach the master weights
        dws = [g.to(torch.bfloat16).to(dt) for g, dt in zip(grads[1:], ctx.dtypes)]
        return (dx, *dws, None, None)


def fused_ln_mlp(x: torch.Tensor, block, eps: float = 1e-6,
                 save_acts: bool = False) -> torch.Tensor:
    """x + MLP(LN2(x)) over bf16 tokens x [..., D] (rows are independent),
    differentiable in x and in the block's LN2, fc1 and fc2 parameters.

    :param block: a ``models.vit.Block``; its weights are used as bf16.
    :param save_acts: the forward keeps the bf16 pre-GELU hidden and the
        backward skips its recompute (``_kernel_save`` / ``_bwd_kernel_saved``).
    """
    return _FusedLnMlp.apply(x, *_weights(block), eps, bool(save_acts))
