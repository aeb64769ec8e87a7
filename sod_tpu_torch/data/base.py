"""Dataset base class of the port (twin of ``sod_tpu/data/base.py``).

Samples are plain dicts of NumPy arrays; batching/prefetch live in
``sod_tpu_torch.data.loader``.  Test-mode samples keep the ORIGINAL image
resolution (the reference's base ``__getitem__`` never resizes in test
mode, ``datasets/base_dataset.py:228-256``) — the evaluator handles
variable sizes with fixed-canvas batching.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from sod_tpu_torch.data.augment import (
    geometric_augmentations,
    normalize,
    photometric_augmentations,
)


class BaseDataset:
    name: str = ""
    ignore_index: int = -1

    def __init__(self):
        self.p_imgs: List[str] = []
        self.p_gts: Optional[List[str]] = []
        self.mode: str = ""
        self.use_aug: bool = False
        self.img_size: Tuple[int, int] = (224, 224)
        self.scale_range: Tuple[float, float] = (0.1, 1.0)
        self.mean = (0.485, 0.456, 0.406)
        self.std = (0.229, 0.224, 0.225)
        # augmentation RNG stream: the loader bumps ``epoch`` so every
        # (seed, epoch, index) triple gets an independent, reproducible
        # generator (the reference relies on global RNG state in its
        # DataLoader worker processes)
        self.seed: int = 0
        self.epoch: int = 0

    def sample_rng(self, ind: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, ind])

    # --- mode handling (ref base_dataset.py:166-180) -----------------------
    def set_mode(self, mode: str) -> None:
        self.p_imgs = getattr(self, f"p_{mode}_imgs")
        self.p_gts = getattr(self, f"p_{mode}_gts", None)
        self.mode = mode

    def use_data_augmentation_(self, flag: bool) -> None:
        self.use_aug = flag

    def __len__(self) -> int:
        return len(self.p_imgs)

    # When True, __getitem__ returns the raw uint8 image under "image_u8"
    # instead of the host-normalized float — the batched evaluator ships
    # uint8 canvases and normalizes on device (4x less host->HBM traffic,
    # bit-identical values).
    return_raw: bool = False

    # --- default test-mode item (ref base_dataset.py:228-256) --------------
    def __getitem__(self, ind: int) -> dict:
        p_img = self.p_imgs[ind]
        image = Image.open(p_img).convert("RGB")
        gt = np.asarray(Image.open(self.p_gts[ind]).convert("L"), np.int64)
        if gt.max() > 1:
            gt = (gt > 0).astype(np.int64)
        out = {
            "masks": gt[None].astype(np.uint8),                  # [1, H, W]
            "filename": os.path.basename(p_img),
            "p_img": p_img,
        }
        arr = np.asarray(image, np.uint8)
        if self.return_raw:
            out["image_u8"] = arr                                # [H, W, 3]
        else:
            out["image"] = normalize(arr.astype(np.float32))
        return out

    # --- shared train-time augmentation (ref base_dataset.py:57-136) -------
    def _augment_train(self, rng: np.random.Generator, image: Image.Image,
                       masks: np.ndarray, crop_size: int,
                       ignore_index: int = 0):
        arr, masks = geometric_augmentations(
            rng, image, masks, scale_range=self.scale_range,
            crop_size=crop_size, ignore_index=ignore_index, hflip_p=0.5)
        arr = photometric_augmentations(rng, arr)
        return arr, masks
