"""Visualization grids (ref ``utils/visualizer.py:9-95`` +
``base_structure.py:55-100``).

Renders training/eval debug grids: input image, GT mask, the selected
query's prediction (red border) and every query mask, saved as PNG via
matplotlib.  Also the evaluator's objectness-ranked mask grid.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from sod_tpu_torch.data.augment import denormalize


def _to_img(x: np.ndarray) -> np.ndarray:
    """Normalized [H, W, 3] float -> uint8 RGB (uint8 passes through —
    the Evaluator feeds raw canvas crops)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return denormalize(x)


# Fixed palette for the non-binary-classifier composition (any distinct
# colors work; the reference uses matplotlib's default color cycling)
_PALETTE = np.array(
    [[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
     [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
     [188, 189, 34], [23, 190, 207]], np.float32) / 255.0


def compose_argmax_map(pred_masks: np.ndarray,
                       palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Non-binary-classifier eval visualization (ref evaluator pyc 240-269):
    the per-pixel argmax over queries is one-hot-composed into a color map
    via ``einsum("qhw,qc->chw")``.

    :param pred_masks: [Q, H, W] mask activations.
    :return: [H, W, 3] float RGB in [0, 1].
    """
    pred_masks = np.asarray(pred_masks)
    q = pred_masks.shape[0]
    if palette is None:
        palette = _PALETTE[np.arange(q) % len(_PALETTE)]
    seg = np.argmax(pred_masks, axis=0)                       # [H, W]
    onehot = (seg[None] == np.arange(q)[:, None, None]).astype(np.float32)
    chw = np.einsum("qhw,qc->chw", onehot, palette[:q].astype(np.float32))
    return chw.transpose(1, 2, 0)


class Visualizer:
    """Callable used by the Trainer hook and the Evaluator dumps."""

    def __init__(self, dir_out: str):
        self.dir_out = dir_out
        os.makedirs(dir_out, exist_ok=True)

    def grid(self, image: np.ndarray, gt_mask: Optional[np.ndarray],
             pred_masks: np.ndarray, selected: Optional[int],
             objectness: Optional[np.ndarray], fp: str,
             composed: Optional[np.ndarray] = None) -> str:
        """One sample: image | GT | selected pred | all query masks.

        :param pred_masks: [Q, h, w] in [0, 1];
        :param selected: highlighted query index (red border, ref
            ``utils/visualizer.py:60-75``);
        :param composed: optional [h, w, 3] RGB panel shown in the
            selected-pred slot — the non-binary-classifier einsum argmax
            composition (ref evaluator pyc 240-269).
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        q = len(pred_masks)
        n_cols = max(4, min(q, 10))
        n_rows = 1 + -(-q // n_cols)
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(2.0 * n_cols, 2.0 * n_rows))
        axes = np.atleast_2d(axes)
        for ax in axes.ravel():
            ax.axis("off")

        axes[0, 0].imshow(_to_img(image))
        axes[0, 0].set_title("input", fontsize=8)
        if gt_mask is not None:
            axes[0, 1].imshow(np.asarray(gt_mask), cmap="gray")
            axes[0, 1].set_title("GT", fontsize=8)
        if composed is not None:
            axes[0, 2].imshow(np.clip(np.asarray(composed), 0.0, 1.0))
            axes[0, 2].set_title("argmax comp", fontsize=8)
        elif selected is not None:
            axes[0, 2].imshow(np.asarray(pred_masks[selected]), cmap="gray")
            axes[0, 2].set_title(f"selected q{selected}", fontsize=8)
            for spine in axes[0, 2].spines.values():
                spine.set_edgecolor("red")
                spine.set_linewidth(3)
            axes[0, 2].axis("on")
            axes[0, 2].set_xticks([])
            axes[0, 2].set_yticks([])

        order = (np.argsort(-np.asarray(objectness))
                 if objectness is not None else np.arange(q))
        for rank, qi in enumerate(order):
            r, c = 1 + rank // n_cols, rank % n_cols
            if r >= n_rows:
                break
            ax = axes[r, c]
            ax.imshow(np.asarray(pred_masks[qi]), cmap="gray")
            title = f"q{qi}"
            if objectness is not None:
                title += f" {float(objectness[qi]):.2f}"
            ax.set_title(title, fontsize=7)
            if selected is not None and qi == selected:
                ax.axis("on")
                ax.set_xticks([])
                ax.set_yticks([])
                for spine in ax.spines.values():
                    spine.set_edgecolor("red")
                    spine.set_linewidth(3)

        out = os.path.join(self.dir_out, fp)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.tight_layout()
        fig.savefig(out, dpi=80)
        plt.close(fig)
        return out

    def eval_grid(self, image_u8: np.ndarray, gt_mask: Optional[np.ndarray],
                  pred_masks: np.ndarray,
                  objectness: Optional[np.ndarray], fp: str) -> str:
        """Evaluator in-loop dump (ref evaluator pyc 240-269, rendered
        every 250 batches).  Binary-classifier checkpoints: objectness-
        ranked grid with the argmax-objectness query highlighted.  Non-bc
        checkpoints (``objectness`` None): the per-pixel einsum argmax
        composition replaces the selected-query panel."""
        if objectness is not None:
            sel = int(np.argmax(np.asarray(objectness)))
            return self.grid(image_u8, gt_mask, pred_masks, sel,
                             objectness, fp)
        return self.grid(image_u8, gt_mask, pred_masks, None, None, fp,
                         composed=compose_argmax_map(pred_masks))

    def __call__(self, epoch: int, it: int, batch: Dict, params=None,
                 outputs: Optional[Dict] = None) -> Optional[str]:
        """Trainer hook (dump dir layout ref trainer pyc 134-164:
        ``{dataset}/{epoch:02d}/...png``)."""
        if outputs is None:
            return None
        image = batch["image"][0]
        gt = batch["gt_masks"][0][0] if "gt_masks" in batch else None
        preds = np.asarray(outputs["mask_pred"])[0]
        if preds.ndim == 4:              # [L, Q, h, w] -> last layer
            preds = preds[-1]
        obj = None
        if "objectness" in outputs:
            obj = np.asarray(outputs["objectness"])[0]
            if obj.ndim == 3:            # [L, Q, 1]
                obj = obj[-1, :, 0]
            elif obj.ndim == 2:          # [Q, 1] or [L, Q]? -> flatten
                obj = obj[..., -1] if obj.shape[-1] == 1 else obj[-1]
        sel = int(np.argmax(obj)) if obj is not None else None
        return self.grid(image, gt, preds, sel, obj,
                         f"{epoch:02d}/{it:05d}.png")


def extract_selected_predictions(pred_masks: np.ndarray,
                                 gt_to_query: Sequence[int]) -> np.ndarray:
    """Gather matched query masks (ref ``base_structure.py:26-53``
    ``_extract_selected_predictions``): [B, Q, h, w] + per-image indices ->
    [B, h, w]."""
    pred_masks = np.asarray(pred_masks)
    out = np.stack([pred_masks[b, int(q)]
                    for b, q in enumerate(gt_to_query)], 0)
    return out
