"""BaseStructure of the port (twin of ``sod_tpu/train/base_structure.py``):
the reference's model-holder base class (``base_structure.py:18-100``) with
``_forward``, ``_extract_selected_predictions`` and ``_visualize``, over
the port's ``MaskFormer``.  Nothing in the port derives from it; it is the
surface for API-compatible consumers."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig


def _host(a) -> np.ndarray:
    """numpy view of an array or a (device) tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() if a.is_floating_point() \
            else a.detach().cpu().numpy()
    return np.asarray(a)


class BaseStructure:
    def __init__(self, model: MaskFormer, cfg: Optional[Config] = None,
                 mcfg: Optional[MaskFormerConfig] = None, visualizer=None):
        """:param model: a ``MaskFormer`` on the device it runs on; its
        weights are used as they are."""
        self.model = model
        self.cfg = cfg or Config()
        self.mcfg = mcfg or model.cfg
        self.visualizer = visualizer
        self._compute = (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                         else torch.float32)

    def _forward(self, dict_data: Dict, encoder_only: bool = False,
                 skip_decoder: bool = False, device=None) -> Dict:
        """ref ``base_structure.py:18-24`` (``skip_decoder`` is accepted and
        ignored as the reference decoder does; ``device`` mirrors the
        pyc-era keyword: the model's device is used)."""
        x = dict_data["x"] if "x" in dict_data else dict_data["image"]
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.dim() == 3:
            x = x[None]
        if x.shape[1] == 3 and x.shape[-1] != 3:     # NCHW -> NHWC
            x = x.permute(0, 2, 3, 1)
        x = x.to(next(self.model.parameters()).device, self._compute)
        with torch.no_grad():
            return self.model(x, encoder_only=encoder_only)

    @staticmethod
    def _extract_selected_predictions(mask_pred, gt_to_query: Sequence[int]):
        """ref ``base_structure.py:26-53``: gather matched query masks."""
        from sod_tpu_torch.utils.visualizer import extract_selected_predictions

        return extract_selected_predictions(_host(mask_pred), gt_to_query)

    def _visualize(self, dict_data: Dict, outputs: Dict, fp: str):
        """ref ``base_structure.py:55-100``: objectness-ranked mask grid
        (without objectness, the non-bc head: no query selected)."""
        if self.visualizer is None:
            return None
        image = _host(dict_data.get("image", dict_data.get("x")))
        if image.ndim == 4:
            image = image[0]
        if image.shape[0] == 3 and image.shape[-1] != 3:
            image = image.transpose(1, 2, 0)
        preds = _host(outputs["mask_pred"])[0, -1]
        obj = (_host(outputs["objectness"])[0, -1, :, 0]
               if "objectness" in outputs else None)
        sel = int(np.argmax(obj)) if obj is not None else None
        gt = dict_data.get("m")
        if gt is not None:
            gt = _host(gt)
            gt = gt[0] if gt.ndim > 2 else gt
        return self.visualizer.grid(image, gt, preds, sel, obj, fp)
