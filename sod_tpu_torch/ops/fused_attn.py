"""Attention half of a ViT block as hand-written CUDA kernel chains: the
gridded inference forward K5 and the training pair K3 (forward and
backward).

Port of ``sod_tpu/ops/fused_attn.py``: x + proj(MHSA(LN1(x))) on bf16 tokens
padded to a multiple of 128.  The kernels are
``sod_tpu_torch/csrc/fused_attn.cu``; its header says how they are laid out.
Their rounding points differ from K1's attention half: qkv and the output
are bf16.

* K5, ``fused_ln_attn_infer``: the large-N pipeline (the Pallas kernels
  ``_ln_qkv_kernel``, ``_attn_proj_kernel`` and ``_attn_proj_masked_kernel``,
  launched by ``_fwd_pallas_large``), any token count, optional key mask,
  not differentiable.
* K3, ``fused_ln_attn``: the training pair (``_fwd_kernel``,
  ``_fwd_kernel_save``, ``_fwd_kernel_save_attn`` in ``_fwd_pallas``;
  ``_bwd_kernel``, ``_bwd_kernel_saved``, ``_bwd_kernel_attn`` in
  ``_bwd_pallas``) as a ``torch.autograd.Function``.  On this card qkv and
  the attention output pass through device memory in every variant, so the
  save mode decides what the Function keeps for the backward (``save_attn``:
  the [B, n_pad, D] attention output; ``save_acts``: the [B, n_pad, 3D]
  qkv; neither: only x), and the backward recomputes the rest.  Every mode
  also keeps each row's softmax max and sum (f32 [B, H, n_pad]).

For a CUDA tensor the wrappers launch the kernels or raise (build, launch
return code, shapes, a dtype other than bf16); the plain versions
(``fused_ln_attn_infer_reference``, ``fused_ln_attn_reference``,
``fused_ln_attn_backward_reference``) run only for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sod_tpu_torch.ops.fused_block import HEAD_DIMS, check_tokens
from sod_tpu_torch.ops.fused_mlp import _ln_pieces, check_aligned, ln_backward_reference
from sod_tpu_torch.ops.layers import layer_norm, linear

#: widest model the training pair takes (``sod_tpu``'s ``_MAX_D``; the
#: LayerNorm backward's shared memory ends at 1024).  ``sod_tpu`` also caps
#: the padded token count at 1536, the TPU's VMEM; these kernels take any.
MAX_D = 768

launches = 0                   # K5 kernel-chain launches, one per call
train_fwd_launches = 0         # K3 forward chains
train_bwd_launches = 0         # K3 backward chains
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
    check_aligned(tensors, "fused attention")
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


def _forward_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   n_heads: int, n_real: int,
                   key_mask: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out in x's dtype, then f32 copies of the bf16 LN1 output, qkv and
    pre-projection attention output) with the kernels' rounding points.

    Weights are rounded to bf16 and every product runs on f32 copies of
    bf16 values.  Rounded to bf16: LN1's output, qkv, the normalised
    probabilities, each head's p.v, and the output x + attn.Wproj + b."""
    bf16 = torch.bfloat16
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = (
        w.detach().to(device=x.device, dtype=bf16).float() for w in weights)
    x0 = x.float()
    h = layer_norm(x0, ln_w, ln_b, eps).to(bf16).float()
    qkv = (torch.matmul(h, wqkv.t()) + bqkv).to(bf16).float()
    attn = attention_plain(qkv, n_heads, n_real, key_mask)
    out = (x0 + torch.matmul(attn, wproj.t()) + bproj).to(x.dtype)
    return out, h, qkv, attn


def attention_plain(qkv: torch.Tensor, n_heads: int, n_real: int,
                    key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-head softmax attention over packed rows qkv [B, N, 3D] (f32
    copies of bf16 values) with the kernels' rounding points: f32 scores and
    softmax, keys >= n_real or masked excluded, bf16(bf16(p) . v).  Returns
    f32 copies of the bf16 output [B, N, D].  One head at a time, so the
    f32 scores of a canvas batch stay small."""
    bf16 = torch.bfloat16
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    key_ok = torch.arange(n, device=qkv.device) < n_real
    key_ok = key_ok[None, :].expand(b, n)
    if key_mask is not None:
        key_ok = key_ok & key_mask.to(device=qkv.device, dtype=torch.bool)
    heads = []
    for i in range(n_heads):
        q, k, v = (qkv[..., j * d + i * hd:j * d + (i + 1) * hd] for j in range(3))
        p = _probs(q, k, hd ** -0.5, key_ok)
        heads.append(torch.matmul(p.to(bf16).float(), v).to(bf16).float())
    return torch.cat(heads, dim=-1)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float,
           key_ok: torch.Tensor) -> torch.Tensor:
    """f32 softmax(q k^T * scale) over [B, N, hd] with excluded keys at -1e30."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = torch.where(key_ok[:, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_ln_attn_infer_reference(x: torch.Tensor, block, n_heads: int,
                                  n_real: int,
                                  key_mask: Optional[torch.Tensor] = None,
                                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the K5 kernel (``_forward_plain``)."""
    return _forward_plain(x, _weights(block), n_heads, n_real, key_mask, eps)[0]


# ---------------------------------------------------------------------------
# K3: the training pair
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _train_kernels():
    """The K3 entries of ``csrc/fused_attn.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    lib = load("fused_attn")
    fwd, bwd = lib.sod_fused_ln_attn_train_fwd, lib.sod_fused_ln_attn_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int]
                    + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    scratch = lib.sod_fused_ln_attn_bwd_scratch
    scratch.restype = None
    scratch.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    return fwd, bwd, scratch


def bwd_scratch_floats(rows: int, d: int) -> Tuple[int, int]:
    """f32 elements of the backward's partial buffers at ``rows`` rows:
    (the weight gradients' row splits, the LayerNorm backward's blocks), as
    the kernels' plan gives them."""
    out = (ctypes.c_longlong * 2)()
    _train_kernels()[2](rows, d, out)
    return out[0], out[1]


def _count(kind: str) -> None:
    global train_fwd_launches, train_bwd_launches
    with _launch_lock:
        if kind == "fwd":
            train_fwd_launches += 1
        else:
            train_bwd_launches += 1


def _check_train(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 n_heads: int, n_real: int) -> None:
    """What the training kernels take: [B, n_pad, D] contiguous bf16 with
    n_pad % 128 == 0, D % 64 == 0, D <= MAX_D, head dim 32, 64 or 128."""
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous [B, n_pad, D] bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, n, d = x.shape
    if n % 128 or not 0 < n_real <= n:
        raise ValueError(f"need n_pad % 128 == 0 and 0 < n_real <= n_pad, got "
                         f"n_pad={n}, n_real={n_real}")
    if d % 64 or d > MAX_D or d % n_heads or d // n_heads not in HEAD_DIMS:
        raise ValueError(f"unsupported width: d={d}, n_heads={n_heads} (need "
                         f"d % 64 == 0, d <= {MAX_D}, head dim in {HEAD_DIMS})")
    if tuple(weights[2].shape) != (3 * d, d) or tuple(weights[4].shape) != (d, d):
        raise ValueError("qkv / proj weights must be (3D, D) and (D, D)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused attention for device {x.device}")


def train_forward_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       n_heads: int, n_real: int, eps: float):
    """Launch the K3 forward chain on padded bf16 tokens with bf16 weights:
    (out, qkv [B, n_pad, 3D], attn [B, n_pad, D], m, l [B, H, n_pad] f32)."""
    b, n, d = x.shape
    dev, bf16 = x.device, torch.bfloat16
    qkv = torch.empty(b, n, 3 * d, device=dev, dtype=bf16)
    attn = torch.empty(b, n, d, device=dev, dtype=bf16)
    m = torch.empty(b, n_heads, n, device=dev, dtype=torch.float32)
    l = torch.empty_like(m)
    out = torch.empty_like(x)
    tensors = [x, *weights, qkv, attn, m, l, out]
    check_aligned(tensors, "fused attention")
    with torch.cuda.device(dev):
        rc = _train_kernels()[0](*(t.data_ptr() for t in tensors), b, n, d,
                                 n_heads, n_real, eps, (d // n_heads) ** -0.5,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_attn forward launch failed: cudaError {rc}")
    _count("fwd")
    return out, qkv, attn, m, l


def train_backward_cuda(x: torch.Tensor, g: torch.Tensor,
                        weights: Sequence[torch.Tensor], n_heads: int,
                        n_real: int, eps: float, m: torch.Tensor,
                        l: torch.Tensor,
                        qkv_saved: Optional[torch.Tensor] = None,
                        attn_saved: Optional[torch.Tensor] = None):
    """Launch the K3 backward chain: (dx bf16, then f32 dLN scale, dLN
    bias, dWqkv (3D, D), dbqkv, dWproj (D, D), dbproj).  ``m``, ``l``: the
    forward's row statistics; what was not saved is recomputed."""
    b, n, d = x.shape
    rows = b * n
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    ln_w, ln_b, wqkv, bqkv, wproj, _ = weights
    qkv = (qkv_saved if qkv_saved is not None
           else torch.empty(b, n, 3 * d, device=dev, dtype=bf16))
    attn = (attn_saved if attn_saved is not None
            else torch.empty(b, n, d, device=dev, dtype=bf16))
    h = torch.empty(rows, d, device=dev, dtype=bf16)
    dattn = torch.empty(rows, d, device=dev, dtype=bf16)
    dsum = torch.empty_like(m)
    dqkv = torch.empty(rows, 3 * d, device=dev, dtype=bf16)
    dh = torch.empty(rows, d, device=dev, dtype=f32)
    colsum = torch.empty(rows // 16, 3 * d, device=dev, dtype=f32)
    n_w, n_ln = bwd_scratch_floats(rows, d)
    part_w = torch.empty(max(n_w, 1), device=dev, dtype=f32)
    part_ln = torch.empty(n_ln, device=dev, dtype=f32)
    dx = torch.empty_like(x)
    dwqkv = torch.empty(3 * d, d, device=dev, dtype=f32)
    dbqkv = torch.empty(3 * d, device=dev, dtype=f32)
    dwproj = torch.empty(d, d, device=dev, dtype=f32)
    dln3 = torch.empty(3, d, device=dev, dtype=f32)
    if m.dtype != f32 or tuple(m.shape) != (b, n_heads, n) or l.shape != m.shape \
            or l.dtype != f32:
        raise ValueError("m and l must be the forward's f32 [B, H, n_pad] residuals")
    tensors = [x, g, ln_w, ln_b, wqkv, bqkv, wproj, qkv, attn, m, l, h, dattn,
               dsum, dqkv, dh, colsum, part_w, part_ln, dx, dwqkv, dbqkv,
               dwproj, dln3]
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused attention tensors must be contiguous")
    check_aligned(tensors, "fused attention")
    p = [t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        rc = _train_kernels()[1](
            *p[:8], int(qkv_saved is not None), p[8], int(attn_saved is not None),
            *p[9:], b, n, d, n_heads, n_real, eps, (d // n_heads) ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_attn backward launch failed: cudaError {rc}")
    _count("bwd")
    return dx, dln3[0], dln3[1], dwqkv, dbqkv, dwproj, dln3[2]


def fused_ln_attn_reference(x: torch.Tensor, block, n_heads: int, n_real: int,
                            eps: float = 1e-6, want: Optional[str] = None):
    """Plain PyTorch version of the K3 forward kernels on padded tokens x
    [B, n_pad, D]: ``want`` None -> out (``_fwd_kernel``); "qkv" -> (out,
    bf16 qkv [B, n_pad, 3D]) (``_fwd_kernel_save``); "attn" -> (out, bf16
    pre-projection attention output) (``_fwd_kernel_save_attn``)."""
    out, _, qkv, attn = _forward_plain(x, _weights(block), n_heads, n_real,
                                       None, eps)
    if want is None:
        return out
    return out, (qkv if want == "qkv" else attn).to(torch.bfloat16)


def fused_ln_attn_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                     weights: Sequence[torch.Tensor],
                                     n_heads: int, n_real: int,
                                     eps: float = 1e-6,
                                     qkv_saved: Optional[torch.Tensor] = None,
                                     attn_saved: Optional[torch.Tensor] = None):
    """Plain version of ``_bwd_kernel`` (nothing saved), ``_bwd_kernel_saved``
    (``qkv_saved``) and ``_bwd_kernel_attn`` (``attn_saved``) on padded tokens
    (``sod_tpu/ops/fused_attn.py:204-333``).  g is rounded to x's dtype
    first (``_core_bwd``).  Returns (dx in x's dtype, then f32 dLN scale,
    dLN bias, dWqkv (3D, D), dbqkv, dWproj (D, D), dbproj), weight
    gradients summed over the batch, in torch's (out, in) layout."""
    bf16 = torch.bfloat16
    ln_w, ln_b, wqkv, bqkv, wproj, _ = (
        w.detach().to(device=x.device, dtype=bf16).float() for w in weights)
    b, n, d = x.shape
    hd = d // n_heads
    scale = hd ** -0.5

    x0 = x.float()
    gf = g.to(x.dtype).float()
    xhat, inv = _ln_pieces(x0, ln_w, eps)
    h = (xhat * ln_w + ln_b).to(bf16).float()
    if qkv_saved is not None:
        qkv = qkv_saved.float()
    else:
        qkv = (torch.matmul(h, wqkv.t()) + bqkv).to(bf16).float()
    gc = gf.to(bf16).float()
    dattn = torch.matmul(gc, wproj).to(bf16).float()
    key_ok = (torch.arange(n, device=x.device) < n_real)[None, :].expand(b, n)

    dqkv = torch.empty_like(qkv)
    dbqkv = torch.empty(3 * d, device=x.device)
    heads = []
    for i in range(n_heads):
        sl = [slice(j * d + i * hd, j * d + (i + 1) * hd) for j in range(3)]
        q, k, v = (qkv[..., s] for s in sl)
        do = dattn[..., i * hd:(i + 1) * hd]
        p = _probs(q, k, scale, key_ok)
        pc = p.to(bf16).float()
        if attn_saved is None:
            heads.append(torch.matmul(pc, v).to(bf16).float())
        dv = torch.matmul(pc.transpose(-1, -2), do)
        dp = torch.matmul(do, v.transpose(-1, -2))
        ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * scale
        dsc = ds.to(bf16).float()
        dq = torch.matmul(dsc, k).to(bf16).float()
        dk = torch.matmul(dsc.transpose(-1, -2), q)
        dqkv[..., sl[0]] = dq
        dqkv[..., sl[1]] = dk.to(bf16).float()
        dqkv[..., sl[2]] = dv.to(bf16).float()
        # bias gradients: the bf16 dq, but the f32 dk and dv (:269,277-282)
        dbqkv[sl[0]] = dq.sum(dim=(0, 1))
        dbqkv[sl[1]] = dk.sum(dim=(0, 1))
        dbqkv[sl[2]] = dv.sum(dim=(0, 1))
    attn = attn_saved.float() if attn_saved is not None else torch.cat(heads, dim=-1)

    rows = lambda t: t.reshape(b * n, t.shape[-1])
    dwproj = torch.matmul(rows(gc).t(), rows(attn))               # (D, D)
    dwqkv = torch.matmul(rows(dqkv).t(), rows(h))                 # (3D, D)
    dh = torch.matmul(rows(dqkv), wqkv)
    dx, dls, dlb, dbproj = ln_backward_reference(dh, rows(xhat), rows(inv),
                                                 ln_w, rows(gf))
    return (dx.reshape(b, n, d).to(x.dtype), dls, dlb, dwqkv, dbqkv, dwproj,
            dbproj)


def fused_ln_attn_twin(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       n_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain differentiable twin of ``sod_tpu``'s ``_reference_forward``
    (``fused_attn.py:621-648``) on unpadded tokens: matmul inputs follow
    ``x.dtype`` (bf16 -> the kernels' precision, f32 -> exact unfused math),
    always accumulated in f32; LayerNorm parameters and biases stay f32."""
    ln_w, ln_b, wqkv, bqkv, wproj, bproj = weights
    b, n, d = x.shape
    hd = d // n_heads
    cast = x.dtype
    xf = x.float()
    h = layer_norm(xf, ln_w, ln_b, eps).to(cast)
    qkv = linear(h, wqkv, bqkv)
    qkv = qkv.reshape(b, n, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                      # [B, H, N, hd]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(cast).float(), v.float()).to(cast)
    attn = o.permute(0, 2, 1, 3).reshape(b, n, d)
    y = torch.matmul(attn.float(), wproj.to(cast).float().t())
    return (xf + y + bproj.float()).to(x.dtype)


class _FusedLnAttn(torch.autograd.Function):
    """K3 on padded bf16 tokens; ``mode``: None | "qkv" | "attn"."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, n_heads, n_real,
                eps, mode):
        weights = (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
        _check_train(x, weights, n_heads, n_real)
        if x.device.type == "cpu":
            out, _, qkv, attn = _forward_plain(x, weights, n_heads, n_real,
                                               None, eps)
            qkv, attn = qkv.to(torch.bfloat16), attn.to(torch.bfloat16)
            kept, stats = weights, ()
        else:
            kept = [w.detach().to(device=x.device, dtype=torch.bfloat16).contiguous()
                    for w in weights]
            out, qkv, attn, m, l = train_forward_cuda(x, kept, n_heads, n_real, eps)
            stats = (m, l)
        extra = {"qkv": (qkv,), "attn": (attn,)}.get(mode, ())
        ctx.args = (n_heads, n_real, eps, mode)
        ctx.dtypes = [w.dtype for w in weights]
        ctx.save_for_backward(x, *kept, *stats, *extra)
        return out

    @staticmethod
    def backward(ctx, g):
        n_heads, n_real, eps, mode = ctx.args
        x, *rest = ctx.saved_tensors
        weights, rest = rest[:6], rest[6:]
        saved = {("qkv_saved" if mode == "qkv" else "attn_saved"): rest[-1]} \
            if mode else {}
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = fused_ln_attn_backward_reference(x, g, weights, n_heads,
                                                     n_real, eps, **saved)
        else:
            grads = train_backward_cuda(x, g, weights, n_heads, n_real, eps,
                                        rest[0], rest[1], **saved)
        dws = [gw.to(dt) for gw, dt in zip(grads[1:], ctx.dtypes)]
        return (grads[0], *dws, None, None, None, None)


def fused_ln_attn(x: torch.Tensor, block, n_heads: int, eps: float = 1e-6,
                  save_acts: bool = False,
                  save_attn: bool = False) -> torch.Tensor:
    """x + proj(MHSA(LN1(x))) over tokens x [B, N, D], differentiable in x
    and in the block's LN1, qkv and proj parameters, with a kernel in both
    directions.

    Tokens are padded to a multiple of 128 here; padded keys are masked
    (``n_real``) and padded rows carry zero gradient (autograd zero-fills
    the slice that is cut off again).  Weight gradients come back in f32
    sums cast to each parameter's dtype, in torch's (out, in) layout.

    :param block: a ``models.vit.Block``; its weights are used as bf16.
    :param save_acts: keep the bf16 qkv for the backward.
    :param save_attn: keep the bf16 pre-projection attention output
        instead (takes precedence, as in ``sod_tpu``).

    Any token count; a width above ``MAX_D`` raises.  An f32 x on the CPU
    runs ``fused_ln_attn_twin`` under autograd (exact unfused math, as
    ``sod_tpu``'s twin off the TPU); an f32 CUDA tensor raises: the kernels
    take bf16 only.
    """
    b, n, d = x.shape
    n_pad = -(-n // 128) * 128
    weights = _weights(block)
    if x.dtype != torch.bfloat16:
        if x.device.type == "cpu":
            return fused_ln_attn_twin(x, weights, n_heads, eps)
        raise ValueError(f"the CUDA kernels take bfloat16, got {x.dtype}")
    mode = "attn" if save_attn else ("qkv" if save_acts else None)
    xp = F.pad(x, (0, 0, 0, n_pad - n)) if n_pad != n else x
    out = _FusedLnAttn.apply(xp.contiguous(), *weights, n_heads, n, eps, mode)
    return out[:, :n] if n_pad != n else out
