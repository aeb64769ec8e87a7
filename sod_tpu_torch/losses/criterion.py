"""Training objective of the port (twin of ``sod_tpu/losses/criterion.py``).

The live branch of ``criterion_forward`` (``use_classification_loss=False``,
the shipped ``use_binary_classifier: true``): dice over every (layer, query,
valid GT row), the ranking loss over queries sorted by descending dice loss,
the supervised InfoNCE term, and the IoU diagnostic; plus the
``objectness is None`` branch.  The Hungarian classification branch is not
ported (ROADMAP item 6, ``ops/hungarian.py``): it raises.

As in ``sod_tpu``, the GT stacks are adjoint-downsampled to the prediction
resolution with the transposed bilinear matrices instead of upsampling the
predictions, and the sums of the upsampled predictions come from the
matrices' column sums; images without a valid GT row leave every sum and
the normalisation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from sod_tpu_torch.ops.resize import _resize_matrix


def dice_loss_matrix(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pairwise dice loss of pred [N, C] and gt [M, C] -> [N, M]."""
    num = 2.0 * torch.matmul(pred.float(), gt.float().t())
    den = pred.sum(-1)[:, None] + gt.sum(-1)[None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     temperature: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised InfoNCE over pooled decoder queries.

    :param features: [B, D]; :param labels: [B] int.
    :param valid: optional [B] bool; invalid rows leave the positives, the
        denominator and the final mean.
    Guards (return 0.0): fewer than 2 valid rows or no positive pairs."""
    b = features.shape[0]
    if b < 2:
        return features.new_zeros((), dtype=torch.float32)
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=features.device)
    validf = valid.float()
    n_valid = validf.sum()

    f = features.float()
    f = f / torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp_min(1e-12)
    sim = torch.matmul(f, f.t()) / temperature                        # [B, B]

    labels = labels.reshape(-1, 1)
    pair_valid = validf[:, None] * validf[None, :]
    pos_mask = (labels == labels.t()).float() * pair_valid
    eye = torch.eye(b, dtype=torch.bool, device=f.device)
    pos_mask = torch.where(eye, torch.zeros_like(pos_mask), pos_mask)

    # max over valid columns only (invalid rows never contribute anyway)
    row_max = torch.where(validf[None, :] > 0, sim,
                          torch.full_like(sim, -torch.inf)
                          ).amax(dim=1, keepdim=True).detach()
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    logits = sim - row_max
    exp_logits = torch.exp(logits)
    non_self = (1.0 - eye.float()) * validf[None, :]
    log_prob = logits - torch.log((exp_logits * non_self).sum(dim=1, keepdim=True)
                                  + 1e-12)
    mean_log_prob_pos = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1) + 1e-12)
    loss = -(mean_log_prob_pos * validf).sum() / n_valid.clamp_min(1.0)
    ok = (pos_mask.sum() > 0) & (n_valid >= 2)
    return torch.where(ok, loss, torch.zeros_like(loss))


def _rank_loss(dice_q: torch.Tensor, objectness_q: torch.Tensor) -> torch.Tensor:
    """Ranking loss over the last axis (Q) of [..., Q]: queries sorted by
    descending dice loss (stable, as jax's argsort), then the negative
    entries of the strictly upper-triangular o_i - o_j summed."""
    q = dice_q.shape[-1]
    order = torch.argsort(-dice_q, dim=-1, stable=True)
    o = torch.gather(objectness_q, -1, order)
    diff = o[..., :, None] - o[..., None, :]
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool, device=o.device),
                       diagonal=1)
    neg = upper & (diff < 0)
    return torch.where(neg, -diff, torch.zeros_like(diff)).sum((-1, -2))


def criterion_forward(
    mask_pred: torch.Tensor,
    gt_masks: torch.Tensor,
    gt_valid: torch.Tensor,
    objectness: Optional[torch.Tensor],
    use_classification_loss: bool,
    features: Optional[torch.Tensor] = None,
    feature_labels: Optional[torch.Tensor] = None,
    weight_contrastive_loss: float = 0.1,
    weight_rank_loss: float = 1.0,
    temperature: float = 0.07,
) -> Dict[str, torch.Tensor]:
    """The criterion over a padded batch.

    :param mask_pred: [B, L, Q, h, w] sigmoid mask predictions.
    :param gt_masks:  [B, M, H, W] binary GT stacks, padded over M.
    :param gt_valid:  [B, M] bool validity of each GT row.
    :param objectness: [B, L, Q, 1] or None.
    :return: ``loss`` plus the per-batch diagnostics of ``sod_tpu``'s dict
        and ``gt_to_query`` [B]."""
    b, l, q, ph, pw = mask_pred.shape
    _, m, H, W = gt_masks.shape
    dev = mask_pred.device

    predf = mask_pred.float()
    pred_flat = predf.reshape(b, l, q, ph * pw)
    gtf = gt_masks.float()
    gt_flat = gtf.reshape(b, m, H * W)

    wh = torch.from_numpy(_resize_matrix(ph, H, "bilinear")).to(dev)   # [H, ph]
    ww = torch.from_numpy(_resize_matrix(pw, W, "bilinear")).to(dev)   # [W, pw]
    # <up(P), G> = <P, up^T(G)>: contract at the prediction resolution
    gt_down = torch.matmul(wh.t(), torch.matmul(gtf, ww)).reshape(b, m, ph * pw)
    ch, cw = wh.sum(0), ww.sum(0)                  # column sums: sum of up(P)
    pred_up_sum = torch.matmul(torch.matmul(predf, cw), ch)            # [B, L, Q]

    img_valid = gt_valid.any(dim=1)                                    # [B]
    n_imgs = img_valid.sum().clamp_min(1)
    gt0 = gt_flat[:, 0]
    gt_sums = gt_flat.sum(-1)                                          # [B, M]
    zero = predf.new_zeros(())

    if objectness is None:
        # sod_tpu keeps the reference's skip of every per-layer loss and
        # returns the contrastive term alone (criterion.py:237-263)
        if features is not None and feature_labels is not None:
            con = contrastive_loss(features, feature_labels, temperature,
                                   valid=img_valid)
        else:
            con = zero
        return {
            "loss": weight_contrastive_loss * con / n_imgs,
            "gt_to_query": torch.zeros(b, dtype=torch.int64, device=dev),
            "avg_loss": zero,
            "avg_contrastive_loss": con,
            "dice_loss": zero,
            "ranking_loss": zero,
            "classification_loss": zero,
            "avg_dice_loss": zero,
            "avg_ranking_loss": zero,
            "avg_classification_loss": zero,
            "avg_iou": zero,
        }
    if use_classification_loss:
        raise NotImplementedError(
            "the Hungarian classification branch of the criterion is not "
            "ported to sod_tpu_torch (ROADMAP item 6, ops/hungarian.py)")

    # dice over every (layer, query, valid gt row): [B, L, Q, M]
    num = 2.0 * torch.matmul(pred_flat, gt_down[:, None].transpose(-1, -2))
    den = pred_up_sum[..., None] + gt_sums[:, None, None, :]
    dice_bl = 1.0 - (num + 1.0) / (den + 1.0)
    dice_total_per_img = torch.where(gt_valid[:, None, None, :], dice_bl,
                                     torch.zeros_like(dice_bl)).sum((1, 2, 3))

    dice_q0 = dice_bl[..., 0]                      # [B, L, Q] vs gt row 0
    rank_per_img = _rank_loss(dice_q0, objectness[..., 0]).sum(1)      # [B]

    dice_loss = torch.where(img_valid, dice_total_per_img, zero).sum()
    ranking_loss = torch.where(img_valid, rank_per_img, zero).sum()

    # gt_to_query: argmin dice of the last layer; IoU of that query's mask,
    # upsampled like sod_tpu's separable resize (W axis first, then H)
    gt_to_query = torch.argmin(dice_q0[:, -1], dim=-1)                # [B]
    sel_low = predf[:, -1][torch.arange(b, device=dev), gt_to_query]  # [B, ph, pw]
    sel = torch.matmul(wh, torch.matmul(sel_low, ww.t())).reshape(b, H * W)
    bin_sel = sel > 0.5
    inter = ((gt0 > 0) & bin_sel).sum(-1).float()
    union = ((gt0 > 0) | bin_sel).sum(-1).float()
    iou = inter / (union + 1e-7)

    total_main = dice_loss + weight_rank_loss * ranking_loss
    if features is not None and feature_labels is not None:
        con = contrastive_loss(features, feature_labels, temperature,
                               valid=img_valid)
    else:
        con = zero
    # normalised by the number of images that contributed (criterion.py:374)
    loss = (total_main + weight_contrastive_loss * con) / n_imgs
    return {
        "loss": loss,
        "gt_to_query": gt_to_query,
        "avg_loss": total_main / n_imgs,
        "avg_contrastive_loss": con,
        "dice_loss": dice_loss,
        "ranking_loss": ranking_loss,
        "classification_loss": zero,
        "avg_dice_loss": dice_loss / n_imgs,
        "avg_ranking_loss": ranking_loss / n_imgs,
        "avg_classification_loss": zero,
        "avg_iou": torch.where(img_valid, iou, zero).sum() / n_imgs,
    }

