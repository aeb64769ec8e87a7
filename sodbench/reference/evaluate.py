"""Plain PyTorch reference of the canvas evaluation: each image's last-layer
masks and objectness as the canvas forward computes them, and the
evaluator's fourteen metrics.

An image of (h, w) pixels in a canvas of G x G patches: its own
(ceil(h/8), ceil(w/8)) patches (the canvas's zero pixels fill the last
partial ones) are the only attention keys and decoder memory, with the
positional table bicubic-resized to its grid; its token grid is extended to
G x G by repeating the last row and column, upsampled x2, the masks of the
last decoder layer computed on it, upsampled x4 to the canvas's pixels and
cut to (h, w).  The selected mask is the query of highest objectness, the
upper bound the query of best IoU with the ground truth.

The metrics (beta^2 = 0.09, as the paper's evaluator squares 0.3): IoU and
pixel accuracy of the mask at 0.5, MAE, the F-measure at 0.5, the F-max over
the thresholds k/255 (k = 0..254, strictly above), the F-mean at twice the
mask's mean, and the S-measure of Fan et al. (alpha 0.5; the region term's
centroid rounded half to even on 0-based indices; an empty quadrant scores
0).  f32 throughout; imports ``torch`` and the reference model only.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from sodbench.reference.model import (Arith, decoder_forward, normalize, pos_embed_for,
                                      vit_forward)

B2 = 0.09
EPS = 1e-7
N_THRESHOLDS = 255
METRICS = ("iou", "pixel_accuarcy", "f_score", "f_max", "f_mean", "mae", "s_measure")


def canvas_masks(P, image_u8: torch.Tensor, canvas_grid: int, ar: Arith = None,
                 patch: int = 8) -> Dict[str, torch.Tensor]:
    """One image, uint8 [h, w, 3]: the last layer's sigmoid masks at the
    canvas's pixels, cut to [Q, h, w], and its objectness [Q]."""
    ar = ar or Arith()
    h, w = image_u8.shape[:2]
    gh, gw = math.ceil(h / patch), math.ceil(w / patch)
    crop = torch.zeros(gh * patch, gw * patch, 3, dtype=torch.uint8, device=image_u8.device)
    crop[:h, :w] = image_u8
    tokens, _ = vit_forward(P, ar, normalize(crop[None]), pos=pos_embed_for(P, gh, gw))
    memory = tokens[:, 1:]
    queries = decoder_forward(P, ar, memory)[:, -1]                     # [1, Q, D]
    g = canvas_grid
    grid = memory.reshape(gh, gw, -1)
    rows = torch.arange(g, device=grid.device).clamp(max=gh - 1)
    cols = torch.arange(g, device=grid.device).clamp(max=gw - 1)
    grid = grid[rows][:, cols].permute(2, 0, 1)[None]                   # [1, D, G, G]
    up = F.interpolate(grid, size=(2 * g, 2 * g), mode="bilinear", align_corners=False)
    masks = torch.sigmoid(torch.einsum("qd,dhw->qhw", queries[0], up[0]))
    masks = F.interpolate(masks[None], size=(patch * g, patch * g), mode="bilinear",
                          align_corners=False)[0, :, :h, :w]
    o = queries
    for i in range(3):
        o = torch.matmul(o, P[f"ffn.layers.{i}.weight"].t()) + P[f"ffn.layers.{i}.bias"]
        if i < 2:
            o = F.relu(o)
    return {"masks": masks, "objectness": torch.sigmoid(o[0, :, 0])}


def _f(prec, rec):
    return (1 + B2) * prec * rec / (B2 * prec + rec + EPS)


def _f_of(binary: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    tp = (binary & gt).sum().float()
    return _f(tp / (binary.sum() + EPS), tp / (gt.sum() + EPS))


def _ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    if n == 0:
        return torch.zeros((), device=x.device)
    mx, my = x.mean(), y.mean()
    dn = n - 1 + 1e-20
    sx = ((x - mx) ** 2).sum() / dn
    sy = ((y - my) ** 2).sum() / dn
    sxy = ((x - mx) * (y - my)).sum() / dn
    alpha = 4 * mx * my * sxy
    beta = (mx * mx + my * my) * (sx + sy)
    if alpha != 0:
        return alpha / (beta + 1e-20)
    return torch.ones((), device=x.device) if beta == 0 else torch.zeros((), device=x.device)


def _object(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return torch.zeros((), device=x.device)
    mean = x.mean()
    sigma = x.std(unbiased=True) if x.numel() > 1 else torch.zeros((), device=x.device)
    return 2.0 * mean / (mean * mean + 1.0 + sigma + 1e-20)


def s_measure(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    gtf = gt.float()
    y = gtf.mean()
    if y == 0:
        return 1.0 - pred.mean()
    if y == 1:
        return pred.mean()
    o_fg = _object(pred[gt])
    o_bg = _object(1.0 - pred[~gt])
    s_object = y * o_fg + (1 - y) * o_bg
    h, w = gt.shape
    total = gtf.sum()
    cx = torch.round((gtf.sum(0) * torch.arange(w, device=gt.device)).sum() / total).long()
    cy = torch.round((gtf.sum(1) * torch.arange(h, device=gt.device)).sum() / total).long()
    X, Y = int(cx), int(cy)
    area = h * w
    wts = (X * Y / area, (w - X) * Y / area, X * (h - Y) / area)
    wts = wts + (1.0 - sum(wts),)
    quads = ((slice(0, Y), slice(0, X)), (slice(0, Y), slice(X, w)),
             (slice(Y, h), slice(0, X)), (slice(Y, h), slice(X, w)))
    s_region = sum(wt * _ssim(pred[r, c].reshape(-1), gtf[r, c].reshape(-1))
                   for wt, (r, c) in zip(wts, quads))
    return (alpha * s_object + (1 - alpha) * s_region).clamp(min=0.0)


def mask_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, float]:
    """The seven metrics of a mask pred [h, w] in [0, 1] against binary gt."""
    binary = pred > 0.5
    inter = (binary & gt).sum().float()
    union = (binary | gt).sum().float()
    thresholds = torch.arange(N_THRESHOLDS, device=pred.device, dtype=torch.float32) \
        * torch.tensor(1.0 / N_THRESHOLDS, dtype=torch.float32)
    above = pred[None] > thresholds[:, None, None]
    tp = (above & gt).sum((1, 2)).float()
    f_sweep = _f(tp / (above.sum((1, 2)) + EPS), tp / (gt.sum() + EPS))
    return {"iou": float(inter / (union + EPS)),
            "pixel_accuarcy": float((binary == gt).float().mean()),
            "f_score": float(_f_of(binary, gt)),
            "f_max": float(f_sweep.max()),
            "f_mean": float(_f_of(pred > 2.0 * pred.mean(), gt)),
            "mae": float((pred - gt.float()).abs().mean()),
            "s_measure": float(s_measure(pred, gt))}


def query_scores(masks: torch.Tensor, objectness: torch.Tensor,
                 gt: torch.Tensor) -> Dict[str, list]:
    """The seven metrics of every query's mask [Q, 7] (``METRICS`` order),
    with the objectness [Q] and the IoU at 0.5 [Q] that pick the selected
    and the upper-bound masks."""
    rows = [mask_metrics(m, gt) for m in masks]
    return {"metrics": [[r[k] for k in METRICS] for r in rows],
            "objectness": [float(o) for o in objectness],
            "iou": [r["iou"] for r in rows]}
