"""IoU / MAE / pixel accuracy of the port (twin of
``sod_tpu/metrics/simple.py``): tensor functions over [..., H, W]."""
from __future__ import annotations

from typing import Optional

import torch


def compute_iou(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                threshold: Optional[float] = 0.5,
                eps: float = 1e-7) -> torch.Tensor:
    """IoU at a binarization threshold."""
    if threshold is not None:
        pred_mask = pred_mask > threshold
    pred_b, gt_b = pred_mask.bool(), gt_mask.bool()
    inter = (pred_b & gt_b).sum(dim=(-1, -2))
    union = (pred_b | gt_b).sum(dim=(-1, -2))
    return inter / (union + eps)


def compute_mae(pred_mask: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return (pred_mask - gt_mask.float()).abs().mean(dim=(-1, -2))


def compute_pixel_accuracy(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                           threshold: Optional[float] = 0.5) -> torch.Tensor:
    """Binary pixel accuracy."""
    if threshold is not None:
        pred_mask = pred_mask > threshold
    return (pred_mask == gt_mask.to(pred_mask.dtype)).float().mean(dim=(-1, -2))
