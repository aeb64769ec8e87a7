"""The train step of the port (twin of ``sod_tpu/train/step.py``).

One step: the uint8 batch normalised on the device, the forward in the
compute dtype (bf16 in the live config, f32 master weights), the criterion
on f32 casts, backward, global-norm clip and AdamW (``train/optim.py``).
``sod_tpu`` jits the whole step; here it runs eagerly on the model's
device, and the metrics stay there as 0-d tensors until the Trainer
fetches them.

Accumulation: ``accum_steps=1``, or ``"averaged"`` over ``accum_steps``
micro-batches (each micro loss normalised by its own valid-image count, the
InfoNCE term over the micro-batch's negatives; gradients summed, then
divided).  ``"exact"`` (GradCache) is ROADMAP item 6: it raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.losses.criterion import criterion_forward
from sod_tpu_torch.models.maskformer import MaskFormer
from sod_tpu_torch.train.optim import ClippedAdamW, global_norm

METRIC_KEYS = ("loss", "dice_loss", "ranking_loss", "classification_loss",
               "contrastive_loss", "iou", "grad_norm")


def make_train_step(cfg, model: MaskFormer, optimizer: ClippedAdamW,
                    accum_steps: int = 1, mode: str = "averaged"
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Build ``train_step(batch) -> metrics`` updating ``model`` in place.

    batch: {"image": [B, H, W, 3] uint8 or float, "gt_masks": [B, M, Hm, Wm],
    "gt_valid": [B, M] bool, "labels": [B] int}, tensors on the model's
    device.  ``grad_norm`` is the global norm before clipping."""
    if mode not in ("averaged", "exact"):
        raise ValueError(f"grad_accum mode must be 'averaged' or 'exact', "
                         f"got {mode!r}")
    if mode == "exact" and accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_mode='exact' (GradCache accumulation) is not ported "
            "to sod_tpu_torch (ROADMAP item 6)")
    compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)

    def loss_fn(batch):
        x = batch["image"]
        if x.dtype == torch.uint8:
            x = normalize_device(x)
        out = model(x.to(compute_dtype))
        res = criterion_forward(
            out["mask_pred"].float(), batch["gt_masks"].float(),
            batch["gt_valid"], out.get("objectness"),
            use_classification_loss=not cfg.use_binary_classifier,
            features=out["features"].float(),
            feature_labels=batch.get("labels"),
            weight_contrastive_loss=cfg.weight_contrastive_loss,
            temperature=cfg.temperature)
        return res["loss"], res

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        if accum_steps <= 1:
            loss, res = loss_fn(batch)
            loss.backward()
        else:
            losses, all_res = [], []
            for k in range(accum_steps):
                micro = {key: v.chunk(accum_steps)[k] for key, v in batch.items()}
                loss_k, res_k = loss_fn(micro)
                loss_k.backward()                 # sums into .grad
                losses.append(loss_k.detach())
                all_res.append(res_k)
            torch._foreach_div_(optimizer.grads(), accum_steps)
            loss = torch.stack(losses).sum() / accum_steps
            res = {key: torch.stack([r[key].float() for r in all_res]).mean()
                   for key in ("avg_dice_loss", "avg_ranking_loss",
                               "avg_classification_loss",
                               "avg_contrastive_loss", "avg_iou")}
        grad_norm = global_norm(optimizer.grads())
        optimizer.step(grad_norm)
        return {"loss": loss.detach(),
                "dice_loss": res["avg_dice_loss"].detach(),
                "ranking_loss": res["avg_ranking_loss"].detach(),
                "classification_loss": res["avg_classification_loss"].detach(),
                "contrastive_loss": res["avg_contrastive_loss"].detach(),
                "iou": res["avg_iou"].detach(),
                "grad_norm": grad_norm}

    return train_step
