"""DUTS dataset of the port (twin of ``sod_tpu/data/duts.py``): DUTS-TE
test split; DUTS-TR train split keyed by the spectral-cluster-voting
pseudo-mask JSON."""
from __future__ import annotations

import json
import os
from glob import glob
from os.path import join
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from sod_tpu_torch.data.augment import normalize, resize_pil
from sod_tpu_torch.data.base import BaseDataset
from sod_tpu_torch.ops import rle as rle_codec


class DUTSDataset(BaseDataset):
    def __init__(
        self,
        dir_dataset: str,
        img_size: int = 224,
        use_pseudo_masks: bool = True,
        pseudo_masks_fp: Optional[str] = None,
        scale_range: Tuple[float, float] = (0.5, 2.0),
        use_copy_paste: bool = False,
    ):
        super().__init__()
        self.p_test_imgs = sorted(glob(join(dir_dataset, "DUTS-TE-Image", "*.jpg")))
        self.p_test_gts = sorted(glob(join(dir_dataset, "DUTS-TE-Mask", "*.png")))

        if not use_pseudo_masks and pseudo_masks_fp is None:
            self.pseudo_masks = None
            self.p_train_imgs = sorted(glob(join(dir_dataset, "DUTS-TR-Image", "*.jpg")))
            self.p_train_gts = sorted(glob(join(dir_dataset, "DUTS-TR-Mask", "*.png")))
        else:
            # train images keyed by the pseudo-mask JSON (ref duts.py:38-42)
            with open(pseudo_masks_fp) as f:
                self.pseudo_masks = json.load(f)
            self.p_train_imgs = [join(dir_dataset, "DUTS-TR-Image", p)
                                 for p in sorted(self.pseudo_masks.keys())]
            self.p_train_gts = None

        self.dir_dataset = dir_dataset
        self.img_size = img_size
        self.name = "duts"
        self.use_pseudo_masks = use_pseudo_masks
        self.scale_range = scale_range
        self.use_aug = True
        self.use_copy_paste = use_copy_paste

    def _get_pseudo_masks(self, filename: str) -> np.ndarray:
        """RLE-decode to [N, H, W] (ref duts.py:100-106)."""
        masks = rle_codec.decode(self.pseudo_masks[filename])
        if masks.ndim == 3:
            masks = masks.transpose(2, 0, 1)
        else:
            masks = masks[None]
        return masks

    def __getitem__(self, ind: int) -> dict:
        p_img = self.p_imgs[ind]
        image = Image.open(p_img).convert("RGB")
        filename = os.path.basename(p_img)

        if self.use_pseudo_masks and self.mode == "train":
            # resize image to (img_size, img_size); pseudo-masks are stored
            # at that resolution already (ref duts.py:117-119)
            image = resize_pil(image, (self.img_size, self.img_size),
                               "bilinear")
            masks = self._get_pseudo_masks(filename)
        else:
            masks = np.asarray(Image.open(self.p_gts[ind]).convert("L"),
                               np.int64)[None]

        if self.mode == "train" and self.use_aug:
            rng = self.sample_rng(ind)
            arr, masks = self._augment_train(rng, image, masks,
                                             crop_size=self.img_size,
                                             ignore_index=0)
        else:
            arr = np.asarray(image, np.float32)

        masks = np.asarray(masks, np.int64)
        if masks.max() > 1:
            masks = masks > 0

        out = {
            "masks": masks.astype(np.uint8),
            "filename": filename,
            "p_img": p_img,
        }
        if self.return_raw and self.mode != "train":
            out["image_u8"] = np.asarray(arr, np.uint8)
        elif self.mode == "train" and getattr(self, "train_u8", False):
            # quantize the augmented image to uint8 (the reference's
            # torchvision photometric ops operate on uint8 PIL images,
            # base_dataset.py:94-102, so this is closer to its pipeline
            # than the float chain) and normalize ON DEVICE — 4x less
            # host->device traffic and one less host pass per sample
            arr32 = np.ascontiguousarray(np.asarray(arr, np.float32))
            from sod_tpu import native

            u8 = native.quantize_u8(arr32)     # one fused pass
            out["image_u8"] = (u8 if u8 is not None else
                               np.clip(np.round(arr32), 0,
                                       255).astype(np.uint8))
        else:
            out["image"] = normalize(arr)
        return out
