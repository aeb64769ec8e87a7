"""F-max threshold-sweep counts K6 as a hand-written CUDA kernel.

Port of ``sod_tpu/ops/fsweep.py`` (the Pallas kernel ``_sweep_kernel``,
entry ``fmax_tp_cnt``): for each (image, mask) and t < n_thr,
tp[t] = |{pred > thr[t]} AND gt| and cnt[t] = |{pred > thr[t]}| inside the
image's valid rectangle, as integer-exact f32 counts.  The kernel is
``sod_tpu_torch/csrc/fsweep.cu``: one launch per call, a per-pixel
threshold index into shared-memory histograms, the last block of each image
taking the suffix sums; its header says why.

The threshold table is the one ``sod_tpu`` compares against.  It writes
``arange(n) / n``, but XLA compiles a division by a constant as a product
with the constant's f32 reciprocal, so the table is f32(t * f32(1 / n)):
126 of the 255 entries sit one ulp away from t / 255 (measured with jax on
the CPU, inside ``jit``).  Both versions here use that table, built once
on the host.

``fmax_tp_cnt`` launches the kernel for CUDA tensors and raises if the
build or the launch fails, or if a tensor is not in the layout the kernel
reads (it casts and copies nothing); the plain version
``fmax_tp_cnt_reference`` runs only for tensors on the CPU.  ``sod_tpu``
runs its kernel only above a pixel count measured on a TPU; the port runs
it at every size (the plain version is slower on the H100 at every size
measured, ``PERF.md``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

MAX_THR = 256                  # histogram bins the kernel is built for
MAX_MASKS = 4                  # masks per image the kernel's histograms hold
_WARPS = 16                    # warps of a block (csrc/fsweep.cu THREADS / 32)
_MAX_BANDS = 32                # bands an image's last block sums

launches = 0                   # kernel launches (one per fmax_tp_cnt call)
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _threshold_table_np(n_thr: int) -> np.ndarray:
    return (np.arange(n_thr, dtype=np.float32) * np.float32(1.0 / n_thr)
            ).astype(np.float32)


def threshold_table(n_thr: int, device) -> torch.Tensor:
    """The f32 thresholds [n_thr] that ``sod_tpu``'s compiled sweep uses,
    made once per device (shared: callers must not write to it)."""
    return _threshold_table(n_thr, torch.device(device))


@functools.lru_cache(maxsize=None)
def _threshold_table(n_thr: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_threshold_table_np(n_thr)).to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/fsweep.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fsweep").sod_fmax_tp_cnt
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def band_rows(b: int, h: int, w: int, n_sm: int = 132) -> int:
    """Rows of the band a block of the kernel takes: all blocks in one wave
    of two per SM, at most ``_MAX_BANDS`` bands an image, at least one row a
    warp, at most 256 rows (the blocks' row lists), and fewer than 65536
    pixels a histogram copy (two warps: the kernel's 16-bit counts)."""
    bands = max(1, min(-(-h // _WARPS), max(1, 2 * n_sm // b), _MAX_BANDS), -(-h // 256))
    rows = min(-(-h // bands), (_WARPS // 2) * 65000 // (w + 3))
    if rows < 1:
        raise ValueError(f"canvas width {w} above the kernel's")
    return rows


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_scratch: dict = {}            # (device, B, M, bands) -> (part, counters)


def _get_scratch(dev: torch.device, b: int, m: int, bands: int):
    """The kernel's scratch, made once per (device, shape) and kept: the
    per-band histograms (overwritten by every call) and the per-image
    counters (zero, and left zero by every call)."""
    key = (dev, b, m, bands)
    with _launch_lock:
        if key not in _scratch:
            _scratch[key] = (
                torch.empty(b * bands * 2 * m * 256, device=dev, dtype=torch.int32),
                torch.zeros(b, device=dev, dtype=torch.int32))
        return _scratch[key]


def _check(masks, gt, rowv, colv, n_thr) -> None:
    if masks.dim() != 4:
        raise ValueError(f"masks must be [B, M, H, W], got {tuple(masks.shape)}")
    b, _, h, w = masks.shape
    if tuple(gt.shape) != (b, h, w) or tuple(rowv.shape) != (b, h) \
            or tuple(colv.shape) != (b, w):
        raise ValueError(f"gt [B, H, W], rowv [B, H], colv [B, W] must match "
                         f"masks {tuple(masks.shape)}: got {tuple(gt.shape)}, "
                         f"{tuple(rowv.shape)}, {tuple(colv.shape)}")
    if not 0 < n_thr <= MAX_THR:
        raise ValueError(f"n_thr={n_thr} outside (0, {MAX_THR}]")


def _check_layout(masks, gt, rowv, colv) -> None:
    """What the kernel reads as it is: f32 masks and gt, one-byte (bool or
    uint8) rowv and colv, all contiguous on one device, at most MAX_MASKS
    masks an image."""
    if masks.dtype != torch.float32 or gt.dtype != torch.float32:
        raise ValueError(f"masks and gt must be float32, got {masks.dtype}, {gt.dtype}")
    if rowv.dtype not in (torch.bool, torch.uint8) or colv.dtype not in (torch.bool,
                                                                         torch.uint8):
        raise ValueError(f"rowv and colv must be bool or uint8, got {rowv.dtype}, "
                         f"{colv.dtype}")
    if not all(t.is_contiguous() and t.device == masks.device
               for t in (masks, gt, rowv, colv)):
        raise ValueError("masks, gt, rowv and colv must be contiguous on one device")
    if not 0 < masks.shape[1] <= MAX_MASKS:
        raise ValueError(f"{masks.shape[1]} masks an image: the kernel takes 1 to "
                         f"{MAX_MASKS}")


def fmax_tp_cnt(masks: torch.Tensor, gt: torch.Tensor, rowv: torch.Tensor,
                colv: torch.Tensor, n_thr: int = 255):
    """Threshold-sweep counts of a batch of masks.

    :param masks: [B, M, H, W] float canvas masks.
    :param gt: [B, H, W] canvas GT (counted where > 0).
    :param rowv: [B, H] bool, row < the image's height; colv [B, W] likewise.
        On the card: masks and gt f32, rowv and colv bool or uint8, all
        contiguous, M <= MAX_MASKS (``ValueError`` otherwise).  Calls on one
        device share the kernel's scratch and run in stream order.
    :return: (tp, cnt), each [B, M, n_thr] f32 holding integer counts.
    """
    _check(masks, gt, rowv, colv, n_thr)
    if masks.device.type == "cpu":
        return fmax_tp_cnt_reference(masks, gt, rowv, colv, n_thr)
    if masks.device.type != "cuda":
        raise ValueError(f"no threshold sweep for device {masks.device}")
    _check_layout(masks, gt, rowv, colv)
    b, m, h, w = masks.shape
    dev = masks.device
    rows = band_rows(b, h, w, _sm_count(dev))
    part, counters = _get_scratch(dev, b, m, -(-h // rows))
    ptrs = [t.data_ptr() for t in (masks, gt, rowv, colv)]
    vec = w % 4 == 0 and ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0 and ptrs[3] % 4 == 0
    out = torch.empty(2, b, m, n_thr, device=dev, dtype=torch.float32)     # tp, cnt
    # the kernel computes the table's entries as t * f32(1 / n_thr), the
    # products _threshold_table_np takes
    inv = float(np.float32(1.0 / n_thr))
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        rc = _kernel()(*ptrs, inv, part.data_ptr(), counters.data_ptr(), out[0].data_ptr(),
                       out[1].data_ptr(), b, m, h, w, n_thr, rows, int(vec),
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fmax_tp_cnt launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return out[0], out[1]


def fmax_tp_cnt_reference(masks: torch.Tensor, gt: torch.Tensor,
                          rowv: torch.Tensor, colv: torch.Tensor,
                          n_thr: int = 255):
    """Plain version: ``sod_tpu``'s XLA twin, one compare per threshold.
    Pixels outside the rectangle (and, for tp, outside the GT) are set to
    -1, below every threshold: the Pallas kernel's sentinel."""
    valid = (rowv.bool()[:, None, :, None] & colv.bool()[:, None, None, :])
    gtb = (gt[:, None] > 0) & valid
    masks = masks.float()
    pm_tp = torch.where(gtb, masks, torch.full_like(masks, -1.0))
    pm_cnt = torch.where(valid, masks, torch.full_like(masks, -1.0))
    tp, cnt = [], []
    for t in _threshold_table_np(n_thr).tolist():
        tp.append((pm_tp > t).sum(dim=(2, 3)))
        cnt.append((pm_cnt > t).sum(dim=(2, 3)))
    return (torch.stack(tp, dim=-1).float(), torch.stack(cnt, dim=-1).float())
