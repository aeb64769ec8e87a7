"""Upsample-and-count K7 for the upper-bound (UB) query choice, as a
hand-written CUDA kernel.

Port of ``sod_tpu/ops/fused_ub.py`` (the Pallas kernel ``_ub_kernel``,
entry ``ub_inter_cnt``).  The UB search scores binarized masks, so every
cost it supports is a function of three integers per (image, query):
inter = |up(low) > 0.5 AND gt| and cnt = |up(low) > 0.5| inside the valid
rectangle, and |gt|.  ``up`` is the bilinear canvas upsample, W axis first,
then H.  The kernel is ``sod_tpu_torch/csrc/fused_ub.cu``: it never writes
the [B, Q, H, W] upsampled stack.

``ub_inter_cnt`` launches the kernel for CUDA tensors and raises if the
build or the launch fails; the plain version ``ub_inter_cnt_reference``
(the evaluator's separable-matmul upsample, then counts) runs only for
tensors on the CPU.  Counts agree exactly given the same upsampled values;
a value within an ulp or so of 0.5 may binarize the other way in the
kernel than in a matmul (see the kernel's header).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from sod_tpu_torch.ops.resize import _resize_matrix, bilinear_separable

MAX_SMEM = 227 * 1024          # shared memory one block may use on Hopper

launches = 0                   # kernel launches (one per ub_inter_cnt call)
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fused_ub.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_ub").sod_ub_inter_cnt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def taps(mat: np.ndarray):
    """The nonzero (index, weight) pairs of each row of an interpolation
    matrix [out, in], two per row (a single tap is padded with weight 0):
    int32 [out, 2] and f32 [out, 2]."""
    mat = np.asarray(mat, np.float32)
    idx = np.zeros((mat.shape[0], 2), np.int32)
    w = np.zeros((mat.shape[0], 2), np.float32)
    for o, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if len(nz) > 2:
            raise ValueError(f"row {o} has {len(nz)} taps: not a bilinear matrix")
        idx[o, :len(nz)] = nz
        w[o, :len(nz)] = row[nz]
    return idx, w


@functools.lru_cache(maxsize=64)
def _device_taps(h0: int, hh: int, w0: int, ww: int, device: torch.device):
    """``taps`` of the bilinear (h0, w0) -> (hh, ww) matrices as tensors on
    ``device``, built once per shape: (row idx, row w, col idx, col w)."""
    (r_idx, r_w), (c_idx, c_w) = (taps(_resize_matrix(h0, hh, "bilinear")),
                                  taps(_resize_matrix(w0, ww, "bilinear")))
    return tuple(torch.from_numpy(a).to(device) for a in (r_idx, r_w, c_idx, c_w))


def _check(low, gt, rowv, colv) -> None:
    if low.dim() != 4:
        raise ValueError(f"low must be [B, Q, h0, w0], got {tuple(low.shape)}")
    b = low.shape[0]
    hh, ww = gt.shape[-2:]
    if tuple(gt.shape) != (b, hh, ww) or tuple(rowv.shape) != (b, hh) \
            or tuple(colv.shape) != (b, ww):
        raise ValueError(f"gt [B, H, W], rowv [B, H], colv [B, W] expected, got "
                         f"{tuple(gt.shape)}, {tuple(rowv.shape)}, {tuple(colv.shape)}")


def ub_inter_cnt(low: torch.Tensor, gt: torch.Tensor, rowv: torch.Tensor,
                 colv: torch.Tensor):
    """Per-(image, query) counts of the binarized masks, upsampled bilinearly
    to the GT's size (``_resize_matrix``'s matrices, W axis first).

    :param low: [B, Q, h0, w0] pre-upsample sigmoid masks.
    :param gt: [B, H, W] canvas GT; rowv [B, H], colv [B, W] bool.
    :return: (inter, cnt), each [B, Q] f32 holding integer counts.
    """
    _check(low, gt, rowv, colv)
    if low.device.type == "cpu":
        return ub_inter_cnt_reference(low, gt, rowv, colv)
    if low.device.type != "cuda":
        raise ValueError(f"no upper-bound counts for device {low.device}")
    b, q, h0, w0 = low.shape
    hh, ww = gt.shape[-2:]
    if h0 * w0 * 4 > MAX_SMEM:
        raise ValueError(f"a {h0}x{w0} f32 mask does not fit a block's shared memory")
    dev = low.device
    args = [low.float().contiguous(), gt.to(dev, torch.float32).contiguous(),
            rowv.to(dev, torch.uint8).contiguous(), colv.to(dev, torch.uint8).contiguous(),
            *_device_taps(h0, hh, w0, ww, dev)]
    inter = torch.empty(b, q, device=dev, dtype=torch.float32)
    cnt = torch.empty_like(inter)
    with torch.cuda.device(dev):
        rc = _kernel()(*(t.data_ptr() for t in (*args, inter, cnt)), b, q, h0, w0,
                       hh, ww, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ub_inter_cnt launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return inter, cnt


def ub_inter_cnt_reference(low: torch.Tensor, gt: torch.Tensor,
                           rowv: torch.Tensor, colv: torch.Tensor):
    """Plain version: ``sod_tpu``'s XLA twin, one query at a time (the
    canvas stack of one query in memory): the evaluator's separable
    upsample, W axis first, then counts."""
    valid = rowv.bool()[:, :, None] & colv.bool()[:, None, :]
    gtb = (gt > 0) & valid
    hh, ww = gt.shape[-2:]
    inter, cnt = [], []
    for lq in low.unbind(1):                                  # [B, h0, w0]
        pb = (bilinear_separable(lq.float(), hh, ww) > 0.5) & valid
        inter.append((pb & gtb).sum(dim=(1, 2)))
        cnt.append(pb.sum(dim=(1, 2)))
    return torch.stack(inter, 1).float(), torch.stack(cnt, 1).float()
