"""Training objective of the port (twin of ``sod_tpu/losses/criterion.py``).

``criterion_forward`` has three branches, as ``sod_tpu``'s:

* the live one (``use_classification_loss=False``, the shipped
  ``use_binary_classifier: true``): dice over every (layer, query, valid GT
  row), the ranking loss over queries sorted by descending dice loss, and
  ``gt_to_query`` the argmin of the last layer's dice;
* the Hungarian classification branch (``use_classification_loss=True``):
  the {background, foreground} targets of GT row 0 matched to queries by
  ``ops.hungarian`` on the detached ``dice - objectness`` cost, then the
  matched dice and ``-log(objectness + 1e-7)``;
* ``objectness is None``: the contrastive term alone.

Both loss branches add the supervised InfoNCE term and the IoU diagnostic.
No branch synchronises with the host: the interpolation matrices are
uploaded once per size and device and kept, and the assignment runs on the
device.

As in ``sod_tpu``, the GT stacks are adjoint-downsampled to the prediction
resolution with the transposed bilinear matrices instead of upsampling the
predictions, and the sums of the upsampled predictions come from the
matrices' column sums; images without a valid GT row leave every sum and
the normalisation.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from sod_tpu_torch.ops.hungarian import hungarian
from sod_tpu_torch.ops.resize import _resize_matrix
from sod_tpu_torch.parallel.mesh import data_group, gather_rows


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``_resize_matrix(n_in, n_out, "bilinear")`` [n_out, n_in] on
    ``device``, uploaded once."""
    return torch.from_numpy(_resize_matrix(n_in, n_out, "bilinear")).to(device)


def dice_loss_matrix(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pairwise dice loss of pred [N, C] and gt [M, C] -> [N, M]."""
    num = 2.0 * torch.matmul(pred.float(), gt.float().t())
    den = pred.sum(-1)[:, None] + gt.sum(-1)[None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def focal_loss_matrix(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 0.25,
                      gamma: float = 2.0, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise RetinaNet focal cost of pred [N, C] and gt [M, C] -> [N, M]:
    ``(fl_pos . gt^T + fl_neg . (1 - gt)^T) / C``."""
    hw = pred.shape[1]
    p = pred.clamp(eps, 1.0 - eps)
    fl_pos = ((1.0 - p) ** gamma) * (-torch.log(p))
    fl_neg = (p ** gamma) * (-torch.log(1.0 - p))
    if alpha >= 0:
        fl_pos = alpha * fl_pos
        fl_neg = (1.0 - alpha) * fl_neg
    return (torch.matmul(fl_pos, gt.t()) + torch.matmul(fl_neg, (1.0 - gt).t())) / hw


def bce_loss_matrix(pred: torch.Tensor, gt: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """Pairwise binary cross-entropy of pred [N, C] and gt [M, C], the mean
    over the C pixels -> [N, M]."""
    p = pred.clamp(eps, 1.0 - eps)
    hw = pred.shape[1]
    pos = torch.matmul(-torch.log(p), gt.t())
    neg = torch.matmul(-torch.log(1.0 - p), (1.0 - gt).t())
    return (pos + neg) / hw


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     temperature: float,
                     valid: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Supervised InfoNCE over pooled decoder queries.

    :param features: [B, D]; :param labels: [B] int.
    :param valid: optional [B] bool; invalid rows leave the positives, the
        denominator and the final mean.
    :param mesh: the data mesh whose ranks hold the other rows of the
        global batch: features, labels and ``valid`` are gathered first, so
        the term is the global batch's (``sod_tpu``'s [B, B] similarity,
        positives and negatives from every rank's images) and alike on
        every rank.  The gather hands each rank the gradient of its own
        rows, so the reduced gradient counts the term once.
    Guards (return 0.0): fewer than 2 valid rows or no positive pairs."""
    if valid is None:
        valid = torch.ones(features.shape[0], dtype=torch.bool, device=features.device)
    if mesh is not None:
        features = gather_rows(features, mesh)
        labels, valid = gather_rows(labels, mesh), gather_rows(valid, mesh)
    b = features.shape[0]
    if b < 2:
        return features.new_zeros((), dtype=torch.float32)
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
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The criterion over a padded batch.

    With a data ``mesh`` the batch is this rank's rows of the global one:
    the image count is the global count (``sod_tpu``'s ``n_imgs`` over the
    whole batch) and the contrastive term the global batch's
    (``contrastive_loss``).  The sums over images are then this rank's
    share: ``loss``, ``avg_loss`` and the ``avg_*`` diagnostics summed over
    the ranks give ``sod_tpu``'s values, except ``avg_contrastive_loss``,
    which is global already, and ``loss`` counts ``weight_contrastive_loss
    * con / n_imgs`` on every rank (the gradient counts it once).

    :param mask_pred: [B, L, Q, h, w] sigmoid mask predictions.
    :param gt_masks:  [B, M, H, W] binary GT stacks, padded over M.
    :param gt_valid:  [B, M] bool validity of each GT row.
    :param objectness: [B, L, Q, 1] or None.
    :param use_classification_loss: the Hungarian-matched branch (the
        train step passes ``not use_binary_classifier``).
    :return: ``loss`` plus the per-batch diagnostics of ``sod_tpu``'s dict
        and ``gt_to_query``: [B] in the live branch, [B, 2] (the background
        and foreground targets' queries on the last layer) in the
        classification branch."""
    b, l, q, ph, pw = mask_pred.shape
    _, m, H, W = gt_masks.shape
    dev = mask_pred.device

    predf = mask_pred.float()
    pred_flat = predf.reshape(b, l, q, ph * pw)
    gtf = gt_masks.float()
    gt_flat = gtf.reshape(b, m, H * W)

    wh = _bilinear_matrix(ph, H, dev)                                   # [H, ph]
    ww = _bilinear_matrix(pw, W, dev)                                   # [W, pw]
    # <up(P), G> = <P, up^T(G)>: contract at the prediction resolution
    gt_down = torch.matmul(wh.t(), torch.matmul(gtf, ww)).reshape(b, m, ph * pw)
    ch, cw = wh.sum(0), ww.sum(0)                  # column sums: sum of up(P)
    pred_up_sum = torch.matmul(torch.matmul(predf, cw), ch)            # [B, L, Q]

    img_valid = gt_valid.any(dim=1)                                    # [B]
    n_imgs = img_valid.sum()
    if mesh is not None:
        dist.all_reduce(n_imgs, group=data_group(mesh))
    n_imgs = n_imgs.clamp_min(1)
    gt0 = gt_flat[:, 0]
    gt_sums = gt_flat.sum(-1)                                          # [B, M]
    zero = predf.new_zeros(())

    if objectness is None:
        # sod_tpu keeps the reference's skip of every per-layer loss and
        # returns the contrastive term alone (criterion.py:237-263)
        if features is not None and feature_labels is not None:
            con = contrastive_loss(features, feature_labels, temperature,
                                   valid=img_valid, mesh=mesh)
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
        # {background, foreground} targets of GT row 0; the background's
        # adjoint is up^T(1) - up^T(G), with up^T(1)[h, w] = ch[h] * cw[w]
        ones_down = (ch[:, None] * cw[None, :]).reshape(-1)           # [hw]
        gt0_down = gt_down[:, 0]
        gt0_sum = gt_sums[:, 0]
        targets_down = torch.stack([ones_down[None] - gt0_down, gt0_down], 1)
        target_sums = torch.stack([H * W - gt0_sum, gt0_sum], 1)      # [B, 2]
        dice_mq = _dice_lowres(pred_flat, targets_down, target_sums,
                               pred_up_sum).transpose(-1, -2)         # [B, L, 2, Q]
        obj = objectness[..., 0].float()                               # [B, L, Q]
        cost = dice_mq - obj[:, :, None, :]
        assign = hungarian(cost.detach().reshape(b * l, 2, q)).reshape(b, l, 2)
        matched_dice = torch.gather(dice_mq, -1, assign[..., None])[..., 0]
        matched_obj = torch.gather(obj, -1, assign)                    # [B, L, 2]
        dice_per_img = matched_dice.sum((1, 2))
        cls_per_img = (-torch.log(matched_obj + 1e-7)).sum((1, 2))
        dice_loss = torch.where(img_valid, dice_per_img, zero).sum()
        classification_loss = torch.where(img_valid, cls_per_img, zero).sum()
        ranking_loss = zero
        total_main = dice_loss + classification_loss
        gt_to_query = assign[:, -1]                                    # [B, 2]
        iou_query = assign[:, -1, 1]          # the matched foreground query
    else:
        # dice over every (layer, query, valid gt row): [B, L, Q, M]
        dice_bl = _dice_lowres(pred_flat, gt_down, gt_sums, pred_up_sum)
        dice_total_per_img = torch.where(gt_valid[:, None, None, :], dice_bl,
                                         torch.zeros_like(dice_bl)).sum((1, 2, 3))
        dice_q0 = dice_bl[..., 0]                  # [B, L, Q] vs gt row 0
        rank_per_img = _rank_loss(dice_q0, objectness[..., 0]).sum(1)  # [B]
        dice_loss = torch.where(img_valid, dice_total_per_img, zero).sum()
        ranking_loss = torch.where(img_valid, rank_per_img, zero).sum()
        classification_loss = zero
        total_main = dice_loss + weight_rank_loss * ranking_loss
        # gt_to_query: argmin dice of the last layer
        gt_to_query = torch.argmin(dice_q0[:, -1], dim=-1)            # [B]
        iou_query = gt_to_query

    # IoU of the chosen query's mask, upsampled like sod_tpu's separable
    # resize (W axis first, then H)
    sel_low = predf[:, -1][torch.arange(b, device=dev), iou_query]    # [B, ph, pw]
    sel = torch.matmul(wh, torch.matmul(sel_low, ww.t())).reshape(b, H * W)
    bin_sel = sel > 0.5
    inter = ((gt0 > 0) & bin_sel).sum(-1).float()
    union = ((gt0 > 0) | bin_sel).sum(-1).float()
    iou = inter / (union + 1e-7)

    if features is not None and feature_labels is not None:
        con = contrastive_loss(features, feature_labels, temperature,
                               valid=img_valid, mesh=mesh)
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
        "classification_loss": classification_loss,
        "avg_dice_loss": dice_loss / n_imgs,
        "avg_ranking_loss": ranking_loss / n_imgs,
        "avg_classification_loss": classification_loss / n_imgs,
        "avg_iou": torch.where(img_valid, iou, zero).sum() / n_imgs,
    }


def _dice_lowres(pred_flat: torch.Tensor, gt_down: torch.Tensor,
                 gt_sums: torch.Tensor, pred_up_sum: torch.Tensor) -> torch.Tensor:
    """Pairwise dice at the prediction resolution: pred_flat [B, L, Q, hw]
    against the adjoint-downsampled GT rows gt_down [B, M, hw], with the
    full-resolution sums gt_sums [B, M] and pred_up_sum [B, L, Q] ->
    [B, L, Q, M]."""
    num = 2.0 * torch.matmul(pred_flat, gt_down[:, None].transpose(-1, -2))
    den = pred_up_sum[..., None] + gt_sums[:, None, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


@dataclass
class Criterion:
    """The configured criterion (``sod_tpu``'s ``Criterion``).  The dice,
    focal, BCE and classification weights are kept for the config; as in
    ``sod_tpu``, only dice enters the total and the others are never read
    by ``criterion_forward``."""
    weight_dice_loss: float = 1.0
    weight_focal_loss: float = 0.0
    weight_bce_loss: float = 0.0
    weight_contrastive_loss: float = 0.1
    temperature: float = 0.07
    weight_cls_loss: float = 0.05
    weight_rank_loss: float = 1.0

    def __call__(self, mask_pred, gt_masks, gt_valid, objectness,
                 use_classification_loss, features=None, feature_labels=None):
        return criterion_forward(
            mask_pred, gt_masks, gt_valid, objectness,
            use_classification_loss, features, feature_labels,
            weight_contrastive_loss=self.weight_contrastive_loss,
            weight_rank_loss=self.weight_rank_loss,
            temperature=self.temperature)
