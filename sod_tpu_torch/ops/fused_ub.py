"""Upsample-and-count K7 for the upper-bound (UB) query choice, as a
hand-written CUDA kernel.

Port of ``sod_tpu/ops/fused_ub.py`` (the Pallas kernel ``_ub_kernel``,
entry ``ub_inter_cnt``).  The UB search scores binarized masks, so every
cost it supports is a function of three integers per (image, query):
inter = |up(low) > 0.5 AND gt| and cnt = |up(low) > 0.5| inside the valid
rectangle, and |gt|.  ``up`` is the bilinear canvas upsample, W axis first,
then H.  The kernel is ``sod_tpu_torch/csrc/fused_ub.cu``: it never writes
the [B, Q, H, W] upsampled stack.

The kernel runs one block per (image, band of ``BAND_ROWS`` canvas rows)
over all queries; ``band_plan`` says which low-res rows each band's taps
touch, made on the host once per shape beside the taps (``_device_taps``).
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
BAND_ROWS = 16                 # canvas rows of a block's band

launches = 0                   # kernel launches (one per ub_inter_cnt call)
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fused_ub.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_ub").sod_ub_inter_cnt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


def taps(mat: np.ndarray):
    """The nonzero (index, weight) pairs of each row of an interpolation
    matrix [out, in], two per row (a single tap is padded with a weight-0
    tap on its own index, so a row touches only its real source rows):
    int32 [out, 2] and f32 [out, 2]."""
    mat = np.asarray(mat, np.float32)
    idx = np.zeros((mat.shape[0], 2), np.int32)
    w = np.zeros((mat.shape[0], 2), np.float32)
    for o, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if not 0 < len(nz) <= 2:
            raise ValueError(f"row {o} has {len(nz)} taps: not a bilinear matrix")
        idx[o] = nz[0]
        idx[o, :len(nz)] = nz
        w[o, :len(nz)] = row[nz]
    return idx, w


def band_plan(r_idx: np.ndarray, rows: int = BAND_ROWS) -> np.ndarray:
    """The low-res rows each band of ``rows`` canvas rows reads: int32
    [bands, 2] = (first low row, number of low rows), from the row taps
    ``r_idx`` [H, 2] of ``taps``."""
    bands = [r_idx[r0:r0 + rows] for r0 in range(0, len(r_idx), rows)]
    return np.array([(b.min(), b.max() - b.min() + 1) for b in bands], np.int32)


def smem_bytes(rows: int, ww: int, max_lr: int, n_q: int, w0: int) -> int:
    """Shared memory of one block of the band kernel (its ``ub_smem_bytes``):
    row taps, column taps, the W pass's rows of two queries, the GT and
    valid bits, the columns valid in any row, the counts, two pairs of
    buffers of low rows, each on a 16-byte boundary."""
    a16 = lambda n: -(-n // 16) * 16                      # noqa: E731
    words = rows * -(-ww // 32)
    return (a16(16 * rows) + 2 * a16(8 * ww) + 2 * a16(4 * max_lr * ww) + 2 * a16(4 * words)
            + a16(4 * -(-ww // 32)) + a16(8 * n_q) + 4 * a16(4 * max_lr * w0))


@functools.lru_cache(maxsize=64)
def _host_taps(h0: int, hh: int, w0: int, ww: int):
    """``taps`` of the bilinear (h0, w0) -> (hh, ww) matrices and the band
    plan of the rows, built once per shape: (row idx, row w, col idx, col w,
    band plan)."""
    (r_idx, r_w), (c_idx, c_w) = (taps(_resize_matrix(h0, hh, "bilinear")),
                                  taps(_resize_matrix(w0, ww, "bilinear")))
    return r_idx, r_w, c_idx, c_w, band_plan(r_idx)


@functools.lru_cache(maxsize=64)
def _device_taps(h0: int, hh: int, w0: int, ww: int, device: torch.device):
    """``_host_taps`` as tensors on ``device``, built once per shape and
    device: (row idx, row w, col idx, col w, band plan)."""
    return tuple(torch.from_numpy(a).to(device) for a in _host_taps(h0, hh, w0, ww))


@functools.lru_cache(maxsize=64)
def _band_launch(h0: int, hh: int, w0: int, ww: int, n_q: int):
    """(bands, the most low rows a band reads) of the band kernel for a shape,
    once per shape; raises ``ValueError`` where a block's shared memory
    cannot hold a band."""
    plan = _host_taps(h0, hh, w0, ww)[4]
    max_lr = int(plan[:, 1].max())
    if smem_bytes(BAND_ROWS, ww, max_lr, n_q, w0) > MAX_SMEM:
        raise ValueError(f"a band of {BAND_ROWS} rows of a {hh}x{ww} canvas from {h0}x{w0} "
                         f"masks and {n_q} queries does not fit a block's shared memory")
    return len(plan), max_lr


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
    n_bands, max_lr = _band_launch(h0, hh, w0, ww, q)
    dev = low.device

    def u8(mask):                               # a bool mask is its bytes: no cast kernel
        mask = mask.to(dev).contiguous()
        return mask.view(torch.uint8) if mask.dtype == torch.bool else mask.to(torch.uint8)

    args = [low.float().contiguous(), gt.to(dev, torch.float32).contiguous(), u8(rowv),
            u8(colv), *_device_taps(h0, hh, w0, ww, dev)]
    # one allocation: the counts [2, B, Q] f32, then the bands' [B, bands, Q, 2] u32
    buf = torch.empty(2 * b * q * (1 + n_bands), device=dev, dtype=torch.float32)
    inter, cnt = buf[:2 * b * q].view(2, b, q)
    with torch.cuda.device(dev):
        rc = _kernel()(*(t.data_ptr() for t in args), buf[2 * b * q:].data_ptr(),
                       inter.data_ptr(), cnt.data_ptr(), b, q, h0, w0, hh, ww, BAND_ROWS,
                       max_lr, torch.cuda.current_stream(dev).cuda_stream)
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
