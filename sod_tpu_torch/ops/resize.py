"""Image resizes of the port (twin of ``sod_tpu/ops/resize.py``).

``sod_tpu`` builds torch's ``F.interpolate(align_corners=False)`` as two
separable f32 matmuls; here it is ``F.interpolate`` itself, run in f32 and
cast back to the input dtype, over the trailing two axes of any tensor.
"""
from __future__ import annotations

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
