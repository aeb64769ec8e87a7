"""The benchmark's inputs, made on the card from the seed: images, pseudo
masks and contrastive labels.  The same seed and stream give the same
tensors, so the program and the reference see one set of inputs."""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch
import torch.nn.functional as F


def seed_value(seed: int, stream: int) -> int:
    """A generator seed from any whole ``seed`` and a stream number: a hash,
    so that seeds beyond 32 bits (the CPU generator keeps only the low 32)
    stay apart."""
    digest = hashlib.sha256(f"{int(seed)}:{int(stream)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_value(seed, stream))
    return g


def images(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 [n, h, w, 3]: smooth random colour fields with pixel noise."""
    low = torch.rand(n, 3, max(2, h // 32), max(2, w // 32), generator=g, device=device)
    img = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False) * 200.0 + 28.0
    img = img + (torch.rand(n, 3, h, w, generator=g, device=device) - 0.5) * 24.0
    return img.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def ellipse_masks(g: torch.Generator, n: int, rows: int, h: int, w: int,
                  per_image: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary ellipses, ``per_image`` (low, high) of the ``rows`` rows valid
    in each image: (uint8 [n, rows, h, w], bool [n, rows])."""
    lo, hi = per_image
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    valid = torch.arange(rows, device=device)[None, :] < count[:, None]
    c = torch.rand(n, rows, 2, generator=g, device=device) * 0.6 + 0.2
    r = torch.rand(n, rows, 2, generator=g, device=device) * 0.3 + 0.1
    y = (torch.arange(h, device=device) + 0.5) / h
    x = (torch.arange(w, device=device) + 0.5) / w
    dy = (y[None, None, :, None] - c[..., 0, None, None]) / r[..., 0, None, None]
    dx = (x[None, None, None, :] - c[..., 1, None, None]) / r[..., 1, None, None]
    masks = ((dy * dy + dx * dx) <= 1.0) & valid[..., None, None]
    return masks.to(torch.uint8), valid


def labels(g: torch.Generator, n: int, classes: int, device) -> torch.Tensor:
    return torch.randint(0, classes, (n,), generator=g, device=device, dtype=torch.int32)
