"""Path-list dataset for pseudo-mask generation (twin of
``sod_tpu/data/custom.py``; ref ``datasets/custom_dataset.py:7-32``)."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
from PIL import Image

from sod_tpu_torch.data.augment import normalize, resize_pil
from sod_tpu_torch.ops.resize import resize_shorter_edge


class CustomDataset:
    def __init__(self, image_paths: List[str], image_size: Optional[int] = None,
                 square: bool = False, raw_uint8: bool = False):
        """:param square: resize to exactly (image_size, image_size), for
        fixed-shape batches, instead of the shorter edge.
        :param raw_uint8: return the resized image as uint8 under
        ``image_u8`` (the mask generator normalises on the device) instead
        of normalised f32 under ``image``."""
        if not image_paths:
            raise ValueError("No image paths are given.")
        self.image_paths = image_paths
        self.image_size = image_size
        self.square = square
        self.raw_uint8 = raw_uint8

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> dict:
        p = self.image_paths[index]
        img = Image.open(p).convert("RGB")
        if self.image_size is not None:
            if self.square:
                size = (self.image_size, self.image_size)
            else:
                w, h = img.size
                size = resize_shorter_edge((h, w), self.image_size)
            img = resize_pil(img, size, "bilinear")
        if self.raw_uint8:
            return {"image_u8": np.asarray(img, np.uint8),
                    "filename": os.path.basename(p), "p_img": p}
        return {"image": normalize(np.asarray(img, np.float32)),
                "filename": os.path.basename(p), "p_img": p}
