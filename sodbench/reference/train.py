"""Plain PyTorch reference of SelfMask's training step: the criterion
(dice over every layer, query and valid pseudo mask; the ranking loss of
the objectness over queries sorted by their dice loss; supervised InfoNCE
over the pooled queries), global-norm clipping at 1 and AdamW under the
per-iteration poly schedule.  f32; imports ``torch``, ``numpy`` and the
reference model only.

The dice is taken on the predictions upsampled (bilinear, half-pixel
centres) to the masks' resolution, as written in the paper's code; the
program contracts the masks down instead, which is the same sum.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sodbench.reference.model import Arith, forward, is_buffer


def dice_loss(pred_up: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred_up [B, L, Q, HW], gt [B, M, HW] -> [B, L, Q, M]."""
    num = 2.0 * torch.einsum("blqp,bmp->blqm", pred_up, gt)
    den = pred_up.sum(-1)[..., None] + gt.sum(-1)[:, None, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def rank_loss(dice_q: torch.Tensor, obj_q: torch.Tensor) -> torch.Tensor:
    """Queries in order of descending dice loss (stable); the sum over pairs
    i < j of max(0, o_j - o_i).  [..., Q] -> [...]."""
    order = torch.argsort(-dice_q, dim=-1, stable=True)
    o = torch.gather(obj_q, -1, order)
    diff = o[..., :, None] - o[..., None, :]
    q = o.shape[-1]
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool, device=o.device), 1)
    return torch.where(upper, F.relu(-diff), torch.zeros_like(diff)).sum((-1, -2))


def info_nce(features, labels, valid, temperature):
    """Supervised contrastive loss over [B, D] features; 0 with fewer than
    two valid rows or no positive pair."""
    b = features.shape[0]
    f = F.normalize(features, dim=1)
    sim = f @ f.t() / temperature
    v = valid.float()
    eye = torch.eye(b, dtype=torch.bool, device=f.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye & valid[:, None] & valid[None, :]
    others = (~eye) & valid[None, :]
    sim = sim - sim.masked_fill(~valid[None, :], float("-inf")).amax(1, keepdim=True).detach()
    log_prob = sim - torch.log((torch.exp(sim) * others).sum(1, keepdim=True) + 1e-12)
    per_row = (pos * log_prob).sum(1) / (pos.sum(1) + 1e-12)
    loss = -(per_row * v).sum() / v.sum().clamp_min(1.0)
    ok = (pos.sum() > 0) & (v.sum() >= 2)
    return torch.where(ok, loss, torch.zeros_like(loss))


def criterion(out, batch, weight_contrastive: float, temperature: float) -> torch.Tensor:
    mask = out["mask_pred"]                               # [B, L, Q, h, w]
    b, l, q, h, w = mask.shape
    gt = batch["gt_masks"].float()                        # [B, M, H, W]
    valid = batch["gt_valid"]
    H, W = gt.shape[-2:]
    up = F.interpolate(mask.reshape(b, l * q, h, w), size=(H, W), mode="bilinear",
                       align_corners=False).reshape(b, l, q, H * W)
    dice = dice_loss(up, gt.reshape(b, -1, H * W))        # [B, L, Q, M]
    img_valid = valid.any(1)
    n = img_valid.sum().clamp_min(1)
    dice_img = (dice * valid[:, None, None, :]).sum((1, 2, 3))
    rank_img = rank_loss(dice[..., 0], out["objectness"]).sum(1)
    main = (torch.where(img_valid, dice_img, 0.0).sum()
            + torch.where(img_valid, rank_img, 0.0).sum())
    con = info_nce(out["features"], batch["labels"], img_valid, temperature)
    return (main + weight_contrastive * con) / n


def poly_lr(base_lr: float, step: int, total_iters: int, power: float = 0.9) -> float:
    """The poly schedule in f32, no warm-up, the first epoch."""
    t = np.float32(step)
    factor = np.maximum(np.float32(1) - t / np.float32(total_iters), np.float32(0))
    return float(np.float32(np.float32(base_lr) * factor ** np.float32(power)))


def train_steps(P: Dict[str, torch.Tensor], batches: Sequence[dict], cfg: dict,
                arch: str, total_iters: int, ar: Arith = None,
                keep_rows: float = 1.0) -> Dict[str, object]:
    """Run len(batches) steps of the reference from weights ``P`` (not
    changed).  Returns each step's loss, the first step's clipped gradient
    per leaf (the gradient as AdamW receives it) and the parameters after
    the last step.

    :param keep_rows: below 1, each batch keeps only its first rows (a
        broken step, for the faults the comparison has to catch)."""
    ar = ar or Arith()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in P.items() if not is_buffer(k)}
    buffers = {k: v for k, v in P.items() if is_buffer(k)}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, cfg["weight_decay"]
    losses: List[float] = []
    first_grad = None
    for step, batch in enumerate(batches):
        if keep_rows < 1.0:
            rows = max(1, int(batch["image"].shape[0] * keep_rows))
            batch = {k: v[:rows] for k, v in batch.items()}
        out = forward({**params, **buffers}, batch["image"], arch, ar, train=True)
        loss = criterion(out, batch, cfg["weight_contrastive_loss"], cfg["temperature"])
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
            scale = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(names, grads)}
            lr = poly_lr(cfg["lr"], step, total_iters)
            t = step + 1
            for k, g in zip(names, grads):
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                params[k].sub_(lr * (upd + wd * params[k]))
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in params.items()}}
