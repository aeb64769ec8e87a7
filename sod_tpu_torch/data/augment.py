"""ImageNet normalization of uint8 images on the device (twin of
``sod_tpu/data/augment.py`` ``normalize_device``).  The constants are
restated here: importing them from ``sod_tpu.data`` would pull in jax."""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_device(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] in 0..255 -> ImageNet-normalized f32, same f32 math
    as ``sod_tpu``: (u8 / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=u8.device)
    return (u8.float() / 255.0 - mean) / std
