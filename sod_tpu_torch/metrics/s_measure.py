"""S-measure (structure measure, Fan et al.) of the port (twin of
``sod_tpu/metrics/s_measure.py``), batched over leading axes.

The reference's centroid-located quadrant slices are membership masks
built from row and column indices against the (rounded, half-to-even)
centroid, and slice statistics are masked sums over masked counts.
``s_measure_rect`` restricts everything to the top-left (h, w) rectangle of
a canvas.  As in ``sod_tpu``, an empty quadrant's SSIM is 0 (the reference
would compute nan with weight 0).
"""
from __future__ import annotations

import torch

_SUM = (-1, -2)


def _masked_mean(x, mask, n):
    return torch.where(n > 0, (x * mask).sum(dim=_SUM) / n.clamp(min=1),
                       torch.zeros_like(n))


def _ssim_masked(pred, gt, mask):
    n = mask.sum(dim=_SUM)
    x = _masked_mean(pred, mask, n)
    y = _masked_mean(gt, mask, n)
    dn = n - 1 + 1e-20
    xe, ye = x[..., None, None], y[..., None, None]
    sigma_x2 = (((pred - xe) ** 2) * mask).sum(dim=_SUM) / dn
    sigma_y2 = (((gt - ye) ** 2) * mask).sum(dim=_SUM) / dn
    sigma_xy = (((pred - xe) * (gt - ye)) * mask).sum(dim=_SUM) / dn

    alpha = 4 * x * y * sigma_xy
    beta = (x * x + y * y) * (sigma_x2 + sigma_y2)
    q = torch.where(alpha != 0, alpha / (beta + 1e-20),
                    (beta == 0).to(alpha.dtype))
    return torch.where(n > 0, q, torch.zeros_like(q))


def _object_score(pred, region_mask):
    """Stats of pred over the region (the reference's unbiased .std)."""
    n = region_mask.sum(dim=_SUM)
    x = _masked_mean(pred, region_mask, n)
    var = (((pred - x[..., None, None]) ** 2) * region_mask).sum(dim=_SUM) \
        / (n - 1).clamp(min=1)
    sigma = torch.where(n > 1, var.clamp(min=0.0).sqrt(), torch.zeros_like(var))
    return 2.0 * x / (x * x + 1.0 + sigma + 1e-20)


def _s_object(pred, gt, valid):
    fg = torch.where(gt == 0, torch.zeros_like(pred), pred)
    bg = torch.where(gt == 1, torch.zeros_like(pred), 1.0 - pred)
    vb = valid > 0
    o_fg = _object_score(fg, ((gt == 1) & vb).float())
    o_bg = _object_score(bg, ((gt == 0) & vb).float())
    u = _masked_mean(gt, valid, valid.sum(dim=_SUM))
    return u * o_fg + (1 - u) * o_bg


def _centroid(gt, h, w):
    """(x, y) int centroid of gt (zero outside the valid rectangle); an
    empty gt gives round(w / 2), round(h / 2) of the valid size."""
    rows, cols = gt.shape[-2:]
    total = gt.sum(dim=_SUM)
    i = torch.arange(cols, dtype=torch.float32, device=gt.device)
    j = torch.arange(rows, dtype=torch.float32, device=gt.device)
    x = torch.round((gt.sum(dim=-2) * i).sum(dim=-1) / total.clamp(min=1e-20))
    y = torch.round((gt.sum(dim=-1) * j).sum(dim=-1) / total.clamp(min=1e-20))
    x = torch.where(total == 0, torch.round(w * 0.5), x)
    y = torch.where(total == 0, torch.round(h * 0.5), y)
    return x.to(torch.int32), y.to(torch.int32)


def _s_region(pred, gt, valid, h, w):
    H, W = gt.shape[-2:]
    X, Y = _centroid(gt, h, w)
    area = h * w
    left = torch.arange(W, device=gt.device) < X[..., None, None]
    top = torch.arange(H, device=gt.device)[:, None] < Y[..., None, None]
    vb = valid > 0
    quadrants = [top & left & vb, top & ~left & vb,
                 ~top & left & vb, ~top & ~left & vb]
    Xf, Yf = X.float(), Y.float()
    w1 = Xf * Yf / area
    w2 = (w - Xf) * Yf / area
    w3 = Xf * (h - Yf) / area
    w4 = 1.0 - w1 - w2 - w3
    q = 0.0
    for mask, wt in zip(quadrants, (w1, w2, w3, w4)):
        q = q + wt * _ssim_masked(pred, gt, mask.float())
    return q


def s_measure_rect(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                   h: torch.Tensor, w: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """Structure measure of the top-left (h, w) rectangle of canvas pairs.

    :param pred_mask, gt_mask: [..., H, W].
    :param h, w: integer tensors of the leading shape ``[...]``."""
    H, W = pred_mask.shape[-2:]
    dev = pred_mask.device
    valid = ((torch.arange(H, device=dev)[:, None] < h[..., None, None])
             & (torch.arange(W, device=dev) < w[..., None, None])).float()
    pred = pred_mask.float() * valid
    gt_raw = gt_mask.float() * valid
    n = valid.sum(dim=_SUM)

    y = _masked_mean(gt_raw, valid, n)
    x = _masked_mean(pred, valid, n)

    gt = (gt_raw >= 0.5).float()
    hf, wf = h.float(), w.float()
    q_mixed = (alpha * _s_object(pred, gt, valid)
               + (1 - alpha) * _s_region(pred, gt, valid, hf, wf))
    q_mixed = q_mixed.clamp(min=0.0)
    return torch.where(y == 0, 1.0 - x, torch.where(y == 1, x, q_mixed))


def s_measure(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
              alpha: float = 0.5) -> torch.Tensor:
    """Structure measure of one full [H, W] pair."""
    h, w = pred_mask.shape[-2:]
    full = lambda v: torch.tensor(v, device=pred_mask.device)  # noqa: E731
    return s_measure_rect(pred_mask, gt_mask, full(h), full(w), alpha)
