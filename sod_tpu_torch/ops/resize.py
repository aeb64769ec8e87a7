"""Image resizes of the port (twin of ``sod_tpu/ops/resize.py``).

``sod_tpu`` builds torch's ``F.interpolate(align_corners=False)`` as two
separable f32 matmuls; here it is ``F.interpolate`` itself, run in f32 and
cast back to the input dtype, over the trailing two axes of any tensor.
``_resize_matrix`` is ``sod_tpu``'s dense interpolation matrix, rewritten
here because ``sod_tpu.ops`` imports jax; the criterion contracts with it.

``bilinear_separable`` is ``sod_tpu``'s own contraction (``_apply_separable``:
the W axis first, then H, f32).  Evaluation thresholds upsampled masks at
0.5 and counts pixels, so its mask upsample uses this form: ``F.interpolate``
differs from it in the last bit at about a third of the outputs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, out_h: int, out_w: int,
                 mode: str) -> torch.Tensor:
    *lead, h, w = x.shape
    y = F.interpolate(x.float().reshape(1, -1, h, w), size=(out_h, out_w),
                      mode=mode, align_corners=False)
    return y.reshape(*lead, out_h, out_w).to(x.dtype)


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    return _interpolate(x, out_h, out_w, "bilinear")


def interpolate_bicubic(x: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    return _interpolate(x, out_h, out_w, "bicubic")


def interpolate_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')`` over the trailing two axes, on
    ``sod_tpu``'s source indices (``_resize_matrix``'s, floor(dst * in / out)
    in f64; torch's own kernel takes the scale in f32): a gather, so the
    values are the input's own."""
    in_h, in_w = x.shape[-2:]
    rows, cols = (torch.as_tensor(_resize_matrix(i, o, "nearest").argmax(1), device=x.device)
                  for i, o in ((in_h, out_h), (in_w, out_w)))
    return x[..., rows[:, None], cols[None, :]]


def resize_shorter_edge(size_hw, target: int):
    """The torchvision ``Resize(int)`` output size (h, w): the shorter edge
    becomes ``target`` and the longer one is truncated, as the reference
    (``int(float(w) / h * output_size)``), not rounded."""
    h, w = size_hw
    if h <= w:
        return target, max(1, int(float(w) / h * target))
    return max(1, int(float(h) / w * target)), target


def separable(x: torch.Tensor, wh, wwt) -> torch.Tensor:
    """Wh . (x . Wwt) over the trailing two axes of ``x`` in f32: the W
    axis first, then H (``sod_tpu``'s ``_apply_separable`` order).

    :param wh: [out_h, in_h] and ``wwt`` [in_w, out_w], numpy or tensors."""
    wh, wwt = (torch.as_tensor(np.asarray(m, np.float32), device=x.device).contiguous()
               for m in (wh, wwt))
    return torch.matmul(wh, torch.matmul(x.float(), wwt))


def bilinear_separable(x: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Bilinear resize of the trailing two axes as ``separable`` against
    ``_resize_matrix``'s matrices, cast back to ``x.dtype``."""
    in_h, in_w = x.shape[-2:]
    return separable(x, _resize_matrix(in_h, out_h, "bilinear"),
                     _resize_matrix(in_w, out_w, "bilinear").T).to(x.dtype)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's bicubic convolution kernel (Keys, A=-0.75)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """Dense (out_size, in_size) f32 interpolation matrix with torch's
    ``align_corners=False`` semantics (``sod_tpu/ops/resize.py:39-75``).
    Cached and shared: callers must not write to it."""
    if in_size == out_size and mode in ("bilinear", "bicubic"):
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    # half-pixel source coordinates (align_corners=False)
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "bilinear":
        # torch clamps the source coordinate at 0 before floor + frac
        src_c = np.clip(src, 0.0, None)
        i0 = np.floor(src_c).astype(np.int64)
        frac = src_c - i0
        i0 = np.clip(i0, 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        for o in range(out_size):
            mat[o, i0[o]] += 1.0 - frac[o]
            mat[o, i1[o]] += frac[o]
    elif mode == "bicubic":
        # torch does not clamp src before the kernel; taps are edge-clamped
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        for o in range(out_size):
            for t in range(-1, 3):
                w = _cubic_kernel(np.array(t - frac[o]))
                idx = int(np.clip(i0[o] + t, 0, in_size - 1))
                mat[o, idx] += float(w)
    elif mode == "nearest":
        # torch 'nearest': src = floor(out * scale)
        idx = np.minimum((np.arange(out_size) * scale).astype(np.int64),
                         in_size - 1)
        for o in range(out_size):
            mat[o, idx[o]] = 1.0
    else:
        raise ValueError(mode)
    return mat.astype(np.float32)
