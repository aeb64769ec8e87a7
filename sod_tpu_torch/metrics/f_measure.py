"""F-measure at a fixed threshold, the max over 255 thresholds and at the
adaptive threshold (twin of ``sod_tpu/metrics/f_measure.py``).

Kept quirk of the reference: its ``beta_square`` is squared again in the
formula, so the coefficient is 0.3 ** 2 = 0.09.
"""
from __future__ import annotations

from typing import Dict

import torch

from sod_tpu_torch.ops.fsweep import threshold_table


def _prec_recall(binary_pred: torch.Tensor, gt: torch.Tensor, eps: float):
    tp = (binary_pred & gt).sum(dim=(-1, -2)).float()
    tp_fp = binary_pred.sum(dim=(-1, -2)).float()
    tp_fn = gt.sum(dim=(-1, -2)).float()
    return tp / (tp_fp + eps), tp / (tp_fn + eps)


def _f(prec, recall, b2, eps):
    return ((1 + b2) * prec * recall) / (b2 * prec + recall + eps)


def f_measure_all(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                  default_thres: float = 0.5, beta_square: float = 0.3,
                  n_bins: int = 255, eps: float = 1e-7) -> Dict[str, torch.Tensor]:
    """The three F-measure variants of one [H, W] mask pair."""
    b2 = beta_square ** 2
    gt = gt_mask.bool()
    f_fixed = _f(*_prec_recall(pred_mask > default_thres, gt, eps), b2, eps)

    thresholds = threshold_table(n_bins, pred_mask.device)
    binary = pred_mask[None] > thresholds[:, None, None]         # [T, H, W]
    f_max = _f(*_prec_recall(binary, gt[None], eps), b2, eps).max()

    adaptive = 2.0 * pred_mask.mean()
    f_mean = _f(*_prec_recall(pred_mask > adaptive, gt, eps), b2, eps)
    return {"f_measure": f_fixed, "f_max": f_max, "f_mean": f_mean}
