"""F-max threshold-sweep counts K6 as a hand-written CUDA kernel.

Port of ``sod_tpu/ops/fsweep.py`` (the Pallas kernel ``_sweep_kernel``,
entry ``fmax_tp_cnt``): for each (image, mask) and t < n_thr,
tp[t] = |{pred > thr[t]} AND gt| and cnt[t] = |{pred > thr[t]}| inside the
image's valid rectangle, as integer-exact f32 counts.  The kernel is
``sod_tpu_torch/csrc/fsweep.cu`` (a per-pixel threshold index into two
shared-memory histograms; its header says why).

The threshold table is the one ``sod_tpu`` compares against.  It writes
``arange(n) / n``, but XLA compiles a division by a constant as a product
with the constant's f32 reciprocal, so the table is f32(t * f32(1 / n)):
126 of the 255 entries sit one ulp away from t / 255 (measured with jax on
the CPU, inside ``jit``).  Both versions here use that table, built once
on the host.

``fmax_tp_cnt`` launches the kernel for CUDA tensors and raises if the
build or the launch fails; the plain version ``fmax_tp_cnt_reference``
runs only for tensors on the CPU.  ``sod_tpu`` runs its kernel only above
a pixel count measured on a TPU; the port runs it at every size.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

MAX_THR = 256                  # histogram bins the kernel is built for

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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


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


def fmax_tp_cnt(masks: torch.Tensor, gt: torch.Tensor, rowv: torch.Tensor,
                colv: torch.Tensor, n_thr: int = 255):
    """Threshold-sweep counts of a batch of masks.

    :param masks: [B, M, H, W] float canvas masks.
    :param gt: [B, H, W] canvas GT (counted where > 0).
    :param rowv: [B, H] bool, row < the image's height; colv [B, W] likewise.
    :return: (tp, cnt), each [B, M, n_thr] f32 holding integer counts.
    """
    _check(masks, gt, rowv, colv, n_thr)
    if masks.device.type == "cpu":
        return fmax_tp_cnt_reference(masks, gt, rowv, colv, n_thr)
    if masks.device.type != "cuda":
        raise ValueError(f"no threshold sweep for device {masks.device}")
    b, m, h, w = masks.shape
    dev = masks.device
    args = [masks.float().contiguous(), gt.to(dev, torch.float32).contiguous(),
            rowv.to(dev, torch.uint8).contiguous(),
            colv.to(dev, torch.uint8).contiguous(), threshold_table(n_thr, dev)]
    hist = torch.empty(b, m, 2, n_thr + 1, device=dev, dtype=torch.int32)
    tp = torch.empty(b, m, n_thr, device=dev, dtype=torch.float32)
    cnt = torch.empty_like(tp)
    with torch.cuda.device(dev):
        rc = _kernel()(*(t.data_ptr() for t in (*args, hist, tp, cnt)),
                       b, m, h, w, n_thr, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fmax_tp_cnt launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return tp, cnt


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
    for t in threshold_table(n_thr, masks.device).tolist():
        tp.append((pm_tp > t).sum(dim=(2, 3)))
        cnt.append((pm_cnt > t).sum(dim=(2, 3)))
    return (torch.stack(tp, dim=-1).float(), torch.stack(cnt, dim=-1).float())
