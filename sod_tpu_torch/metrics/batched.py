"""Batched fixed-canvas metrics of the port (twin of
``sod_tpu/metrics/batched.py``).

Every image of a canvas batch is scored at its true (h, w): reductions are
masked to the top-left rectangle, which gives the values of slicing each
image out first.  Functions take [B, ...] tensors and return [B] tensors;
nothing leaves the device.
"""
from __future__ import annotations

from typing import Dict

import torch

from sod_tpu_torch.metrics.s_measure import s_measure_rect
from sod_tpu_torch.ops.fsweep import fmax_tp_cnt
from sod_tpu_torch.ops.fused_ub import ub_inter_cnt
from sod_tpu_torch.ops.resize import bilinear_separable

_SUM = (-1, -2)
B2 = 0.3 ** 2                  # the reference squares beta_square = 0.3 again


def _rect(shape, h, w, device):
    """[B, H, W] bool: row < h and col < w per image."""
    H, W = shape
    return ((torch.arange(H, device=device)[:, None] < h[:, None, None])
            & (torch.arange(W, device=device) < w[:, None, None]))


def _f(prec, rec, eps):
    return ((1 + B2) * prec * rec) / (B2 * prec + rec + eps)


def rect_metrics(pred: torch.Tensor, gt: torch.Tensor, h: torch.Tensor,
                 w: torch.Tensor, tp_cnt, eps: float = 1e-7
                 ) -> Dict[str, torch.Tensor]:
    """All evaluator metrics of canvas pairs restricted to (h, w).

    :param pred: [B, H, W] float in [0, 1]; gt [B, H, W] binary.
    :param h, w: [B] integer true sizes.
    :param tp_cnt: ([B, 255], [B, 255]) F-max sweep counts of ``pred``
        from ``fmax_tp_cnt``.
    :return: {iou, pixel_acc, f_measure, f_max, f_mean, mae, s_measure},
        each [B].
    """
    valid = _rect(pred.shape[-2:], h, w, pred.device)
    n = valid.sum(dim=_SUM).float()
    gt_b = (gt > 0) & valid
    gtf = gt_b.float()
    predv = torch.where(valid, pred, torch.zeros_like(pred))

    def prec_recall(binary):
        tp = (binary & gt_b).sum(dim=_SUM).float()
        return tp / (binary.sum(dim=_SUM) + eps), tp / (gt_b.sum(dim=_SUM) + eps)

    pb = (pred > 0.5) & valid
    inter = (pb & gt_b).sum(dim=_SUM)
    union = (pb | gt_b).sum(dim=_SUM)
    iou = inter / (union + eps)
    pixel_acc = ((pb == gt_b) & valid).sum(dim=_SUM) / n
    mae = ((predv - gtf).abs() * valid).sum(dim=_SUM) / n
    f_measure = _f(*prec_recall(pb), eps)

    tp, cnt = tp_cnt
    prec = tp / (cnt + eps)
    rec = tp / (gt_b.sum(dim=_SUM)[:, None] + eps)
    f_max = _f(prec, rec, eps).amax(dim=-1)

    adaptive = 2.0 * predv.sum(dim=_SUM) / n
    f_mean = _f(*prec_recall((predv > adaptive[:, None, None]) & valid), eps)

    s_m = s_measure_rect(predv, gtf, h, w)
    return {"iou": iou, "pixel_acc": pixel_acc, "f_measure": f_measure,
            "f_max": f_max, "f_mean": f_mean, "mae": mae, "s_measure": s_m}


def upper_bound_index(pred_masks: torch.Tensor, gt: torch.Tensor,
                      h: torch.Tensor, w: torch.Tensor,
                      quantity: str = "iou") -> torch.Tensor:
    """Best query per image against the GT on the binarized masks: argmax
    IoU@0.5, argmax F-measure (``f_max`` is the same on binary masks) or
    argmin MAE; first index on ties.

    :param pred_masks: [B, Q, H, W]; gt [B, H, W]; h, w [B]."""
    valid = _rect(gt.shape[-2:], h, w, gt.device)
    gt_b = (gt > 0) & valid
    n = valid.sum(dim=_SUM).float()
    pb = (pred_masks > 0.5) & valid[:, None]
    if quantity == "iou":
        inter = (pb & gt_b[:, None]).sum(dim=_SUM)
        union = (pb | gt_b[:, None]).sum(dim=_SUM)
        return torch.argmax(inter / (union + 1e-7), dim=1)
    if quantity in ("f_measure", "f_max"):
        tp = (pb & gt_b[:, None]).sum(dim=_SUM).float()
        prec = tp / (pb.sum(dim=_SUM) + 1e-7)
        rec = tp / (gt_b.sum(dim=_SUM)[:, None] + 1e-7)
        return torch.argmax(_f(prec, rec, 1e-7), dim=1)
    if quantity == "mae":
        mae = ((pb.float() - gt_b.float()[:, None]).abs()
               * valid[:, None]).sum(dim=_SUM) / n[:, None]
        return torch.argmin(mae, dim=1)
    raise ValueError(quantity)


def _sweep_inputs(sizes, H, W, device):
    rowv = torch.arange(H, device=device) < sizes[:, :1]
    colv = torch.arange(W, device=device) < sizes[:, 1:2]
    return rowv, colv


def eval_batch_metrics(pred_masks: torch.Tensor, objectness: torch.Tensor,
                       gt: torch.Tensor, sizes: torch.Tensor,
                       cost_type: str = "iou") -> Dict[str, torch.Tensor]:
    """Per-image metric suite of a canvas batch.

    :param pred_masks: [B, Q, H, W] upsampled-to-canvas sigmoid masks.
    :param objectness: [B, Q]; gt [B, H, W]; sizes [B, 2] true (h, w).
    :return: {metric: [B]} for the 7 metrics of the selected (argmax
        objectness) and ``_ub`` (upper-bound) masks, and both indices.
    """
    H, W = pred_masks.shape[-2:]
    sel_idx = torch.argmax(objectness, dim=1)
    ub_idx = upper_bound_index(pred_masks, gt, sizes[:, 0], sizes[:, 1], cost_type)
    pair = torch.stack([sel_idx, ub_idx], dim=1)                      # [B, 2]
    both = torch.take_along_dim(pred_masks, pair[:, :, None, None], dim=1)
    rowv, colv = _sweep_inputs(sizes, H, W, pred_masks.device)
    tp, cnt = fmax_tp_cnt(both, gt, rowv, colv)                       # [B, 2, 255]
    return _pair_metrics(both, gt, sizes, sel_idx, ub_idx, tp, cnt)


def _pair_metrics(both, gt, sizes, sel_idx, ub_idx, tp, cnt):
    """Full metric suite of the [B, 2, H, W] (selected, UB) mask pairs."""
    h, w = sizes[:, 0], sizes[:, 1]
    out = rect_metrics(both[:, 0], gt, h, w, tp_cnt=(tp[:, 0], cnt[:, 0]))
    for k, v in rect_metrics(both[:, 1], gt, h, w,
                             tp_cnt=(tp[:, 1], cnt[:, 1])).items():
        out[f"{k}_ub"] = v
    out["selected_index"] = sel_idx
    out["ub_index"] = ub_idx
    return out


def _ub_score(inter, cnt, gtsum, n, cost_type):
    """Per-query UB score from the binarized-mask counts: the quantities
    ``upper_bound_index`` computes from the canvas stack.  Returns
    (scores [B, Q], take_max)."""
    if cost_type == "iou":
        return inter / (cnt + gtsum - inter + 1e-7), True
    if cost_type in ("f_measure", "f_max"):
        prec = inter / (cnt + 1e-7)
        rec = inter / (gtsum + 1e-7)
        return _f(prec, rec, 1e-7), True
    if cost_type == "mae":
        return (cnt + gtsum - 2.0 * inter) / n, False
    raise ValueError(cost_type)


def eval_batch_metrics_lowres(low_masks: torch.Tensor, objectness: torch.Tensor,
                              gt: torch.Tensor, sizes: torch.Tensor,
                              cost_type: str = "iou") -> Dict[str, torch.Tensor]:
    """``eval_batch_metrics`` without the upsampled [B, Q, H, W] stack: the
    UB search takes its counts from ``ub_inter_cnt`` (K7), and only the two
    chosen masks per image are upsampled for the metric suite.

    :param low_masks: [B, Q, h0, w0] pre-upsample sigmoid masks.
    :param gt: [B, H, W] binary canvas GT.
    """
    H, W = gt.shape[-2:]
    rowv, colv = _sweep_inputs(sizes, H, W, gt.device)
    inter, cnt_q = ub_inter_cnt(low_masks.float(), gt, rowv, colv)
    valid = rowv[:, :, None] & colv[:, None, :]
    gtsum = ((gt > 0) & valid).sum(dim=_SUM).float()
    n = (sizes[:, 0] * sizes[:, 1]).float()
    scores, take_max = _ub_score(inter, cnt_q, gtsum[:, None], n[:, None], cost_type)
    ub_idx = (torch.argmax(scores, dim=1) if take_max
              else torch.argmin(scores, dim=1))
    sel_idx = torch.argmax(objectness, dim=1)

    pair = torch.stack([sel_idx, ub_idx], dim=1)
    low_pair = torch.take_along_dim(low_masks, pair[:, :, None, None], dim=1)
    both = bilinear_separable(low_pair.float(), H, W)
    tp, cnt = fmax_tp_cnt(both, gt, rowv, colv)
    return _pair_metrics(both, gt, sizes, sel_idx, ub_idx, tp, cnt)
