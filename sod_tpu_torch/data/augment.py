"""Host-side augmentation of the port (twin of ``sod_tpu/data/augment.py``,
NumPy/PIL) and the ImageNet normalisation, on the host and on the device.

The train augmentations are ``sod_tpu``'s line for line: they draw from the
same ``np.random.Generator`` in the same order and call the same
``sod_tpu.native`` C++ helpers (jax-free), so one seed gives byte-identical
samples.  The constants are restated here: importing them from
``sod_tpu.data`` would pull in jax.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------

def resize_pil(image: Image.Image, size_hw: Tuple[int, int],
               interpolation: str) -> Image.Image:
    if interpolation == "bilinear" and image.mode in ("RGB", "L"):
        from sod_tpu import native

        out = native.resize_u8(np.asarray(image, np.uint8), size_hw,
                               "bilinear")    # bit-identical to PIL
        if out is not None:
            return Image.fromarray(out)
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
             "bicubic": Image.BICUBIC}
    return image.resize((size_hw[1], size_hw[0]), modes[interpolation])


def resize_mask_nearest(mask: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of [M, H, W] (torchvision-equivalent 'nearest')."""
    if mask.ndim == 3 and mask.dtype == np.uint8:
        from sod_tpu import native

        out = native.resize_nearest(mask, size_hw)   # bit-identical
        if out is not None:
            return out
    h, w = mask.shape[-2:]
    oh, ow = size_hw
    # torch 'nearest': src = floor(dst * in/out)
    rows = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
    return mask[..., rows[:, None], cols[None, :]]


def random_scale(rng: np.random.Generator, image: Image.Image,
                 scale_range: Tuple[float, float],
                 mask: Optional[np.ndarray] = None):
    scale = rng.uniform(*scale_range)
    w, h = image.size
    hs, ws = int(h * scale), int(w * scale)
    hs, ws = max(hs, 1), max(ws, 1)

    from sod_tpu import native

    resized = native.resize_u8(np.asarray(image, np.uint8), (hs, ws),
                               "bilinear")   # bit-identical to PIL
    image = (Image.fromarray(resized) if resized is not None
             else resize_pil(image, (hs, ws), "bilinear"))
    if mask is not None:
        mask = resize_mask_nearest(mask, (hs, ws))
    return image, mask


def random_crop(rng: np.random.Generator, image: np.ndarray,
                crop_hw: Tuple[int, int], fill,
                offset: Optional[Tuple[int, int]] = None):
    """Crop [H, W, C] (channels-last image) or [M, H, W] (mask stack) with
    constant right/bottom padding to at least the crop size."""
    ch, cw = crop_hw
    is_image = image.ndim == 3 and image.shape[-1] in (1, 3)
    h, w = (image.shape[:2] if is_image else image.shape[-2:])
    if is_image:
        ph, pw = max(ch, h), max(cw, w)
        if ph > h or pw > w:
            # direct paste-into-fill: one allocation instead of np.pad's
            # copy + two fill passes (this path is hot — the scaled train
            # image is almost always smaller than the crop)
            fill_arr = np.asarray(fill, image.dtype).reshape(1, 1, -1)
            padded = np.empty((ph, pw) + image.shape[2:], image.dtype)
            padded[:h, :w] = image
            if ph > h:
                padded[h:, :, :] = fill_arr
            if pw > w:
                padded[:h, w:, :] = fill_arr
        else:
            padded = image
    else:
        padded = np.pad(image, ((0, 0), (0, max(ch - h, 0)),
                                (0, max(cw - w, 0))), constant_values=fill)
        ph, pw = padded.shape[-2:]
    if offset is None:
        offset = (int(rng.integers(0, ph - ch + 1)),
                  int(rng.integers(0, pw - cw + 1)))
    top, left = offset
    if is_image:
        out = padded[top:top + ch, left:left + cw, :]
    else:
        out = padded[..., top:top + ch, left:left + cw]
    return out, offset


def random_hflip(rng: np.random.Generator, image: np.ndarray, p: float,
                 mask: Optional[np.ndarray] = None):
    # NOTE: reference flips when random() > p (geometric_transforms.py:146)
    if rng.random() > p:
        image = image[:, ::-1].copy() if image.ndim == 3 and image.shape[-1] in (1, 3) \
            else image[..., ::-1].copy()
        if mask is not None:
            mask = mask[..., ::-1].copy()
    return image, mask


# ---------------------------------------------------------------------------
# photometric (torchvision-PIL-equivalent math on float arrays)
# ---------------------------------------------------------------------------

def _to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma, as PIL convert('L') (without its rounding)."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])


def adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return np.clip(img * f, 0, 255)


def adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    mean = round(_to_gray(img).mean())
    return np.clip(img * f + mean * (1 - f), 0, 255)


def adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    gray = _to_gray(img)[..., None]
    return np.clip(img * f + gray * (1 - f), 0, 255)


def adjust_hue(img: np.ndarray, f: float) -> np.ndarray:
    """Shift hue by f in [-0.5, 0.5] via uint8 HSV roll (PIL semantics).

    Fast path: the native HSV round-trip (bit-identical to PIL over the
    full RGB cube; skips four PIL<->NumPy image copies)."""
    from sod_tpu import native

    if img.dtype == np.float32 and img.flags.c_contiguous:
        out = native.hue_shift_f32(img, int(f * 255))
        if out is not None:
            return out
    u8 = img.astype(np.uint8)
    out = native.hue_shift(u8, int(f * 255))
    if out is not None:
        return out.astype(np.float32)
    pil = Image.fromarray(u8).convert("HSV")
    hsv = np.array(pil)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(f * 255)) % 256
    return np.array(Image.fromarray(hsv, "HSV").convert("RGB")).astype(np.float32)


def color_jitter(rng: np.random.Generator, img: np.ndarray,
                 brightness: float = 0.8, contrast: float = 0.8,
                 saturation: float = 0.8, hue: float = 0.2) -> np.ndarray:
    """torchvision ColorJitter: uniform factors, random op order.

    Fast path: the brightness/contrast/saturation passes run in-place in
    the native lib (single fused clip passes over float32 — the jitter
    was a top-2 cost of the loader's host budget); hue keeps the PIL HSV
    round-trip.  Same math as the NumPy ops (contrast's gray mean is
    accumulated in float64 there vs NumPy's pairwise float32 — after the
    reference's round() they agree)."""
    bf = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    cf = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    sf = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    hf = rng.uniform(-hue, hue)

    from sod_tpu import native

    if native.available() and img.ndim == 3 and img.shape[-1] == 3:
        buf = np.ascontiguousarray(img, np.float32)
        if buf is img:                     # the in-place ops must not
            buf = img.copy()               # mutate the caller's array
        ops = [lambda x: (native.affine_clip_(x, bf, 0.0), x)[1],
               lambda x: (native.affine_clip_(
                   x, cf, round(native.gray_mean(x)) * (1.0 - cf)), x)[1],
               lambda x: (native.saturate_clip_(x, sf), x)[1],
               lambda x: np.ascontiguousarray(adjust_hue(x, hf),
                                              np.float32)]
        img = buf
    else:
        ops = [lambda x: adjust_brightness(x, bf),
               lambda x: adjust_contrast(x, cf),
               lambda x: adjust_saturation(x, sf),
               lambda x: adjust_hue(x, hf)]
    for i in rng.permutation(4):
        img = ops[i](img)
    return img


def to_grayscale(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.float32 and img.ndim == 3 and img.shape[-1] == 3:
        from sod_tpu import native

        out = native.grayscale3(np.ascontiguousarray(img))
        if out is not None:
            return out
    g = _to_gray(img)
    return np.repeat(np.round(g)[..., None], 3, axis=-1)


def gaussian_blur(rng: np.random.Generator, img: np.ndarray,
                  kernel_size: int, sigma_min: float = 0.1,
                  sigma_max: float = 2.0) -> np.ndarray:
    """cv2.GaussianBlur-equivalent separable blur, reflect-101 border.

    Fast path: ``scipy.ndimage.correlate1d`` (C loop, releases the GIL,
    ``mode='mirror'`` == cv2 BORDER_REFLECT_101) — 6x faster than the
    NumPy fallback and the single biggest cost of the training
    augmentation pipeline (17 -> 2.9 ms/sample at 224 px)."""
    sigma = (sigma_max - sigma_min) * rng.random() + sigma_min
    k = max(int(kernel_size), 1)
    if k % 2 == 0:
        k += 1
    r = k // 2
    x = np.arange(k) - r
    kern = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    kern /= kern.sum()

    from sod_tpu import native

    if native.available() and img.ndim == 3:
        # same separable structure/border as the scipy path; float32
        # accumulation order differs per tap (<= ~1e-4 on [0, 255] data,
        # test-locked) — 2.3x faster on the loader's one-core budget
        out = native.blur_mirror(img.astype(np.float32),
                                 kern.astype(np.float32))
        if out is not None:
            return out
    try:
        from scipy.ndimage import correlate1d
    except ImportError:                       # pragma: no cover
        correlate1d = None
    if correlate1d is not None:
        k32 = kern.astype(np.float32)
        out = correlate1d(img.astype(np.float32), k32, axis=0,
                          mode="mirror")
        out = correlate1d(out, k32, axis=1, mode="mirror")
        return np.clip(out, 0, 255)
    # reflect-101 padding then separable convolution along H and W
    padded = np.pad(img, ((r, r), (r, r), (0, 0)), mode="reflect")
    out = np.zeros_like(img, dtype=np.float64)
    for i, kv in enumerate(kern):
        out += kv * padded[i:i + img.shape[0], r:r + img.shape[1]]
    padded = np.pad(out, ((r, r), (r, r), (0, 0)), mode="reflect")
    out2 = np.zeros_like(out)
    for j, kv in enumerate(kern):
        out2 += kv * padded[r:r + img.shape[0], j:j + img.shape[1]]
    return np.clip(out2, 0, 255)


# ---------------------------------------------------------------------------
# pipelines (ref base_dataset._geometric/_photometric_augmentations)
# ---------------------------------------------------------------------------

def geometric_augmentations(rng: np.random.Generator, image: Image.Image,
                            mask: np.ndarray,
                            scale_range: Tuple[float, float],
                            crop_size: int, ignore_index: int,
                            hflip_p: float = 0.5):
    """random scale -> mean-fill crop (ignore-fill for masks) -> hflip."""
    image, mask = random_scale(rng, image, scale_range, mask)
    arr = np.ascontiguousarray(np.asarray(image, np.float32))

    from sod_tpu import native

    mean3 = native.channel_mean3(arr)
    if mean3 is None:
        mean3 = arr.mean(axis=(0, 1))
    fill = tuple(mean3.astype(np.uint8).tolist())
    arr, offset = random_crop(rng, arr, (crop_size, crop_size), fill)
    mask, _ = random_crop(rng, mask, (crop_size, crop_size), ignore_index,
                          offset=offset)
    arr, mask = random_hflip(rng, arr, hflip_p, mask)
    return arr, mask


def photometric_augmentations(rng: np.random.Generator, img: np.ndarray,
                              jitter_p: float = 0.8,
                              grayscale_p: float = 0.2,
                              blur: bool = True) -> np.ndarray:
    if rng.random() < jitter_p:
        img = color_jitter(rng, img)
    if rng.random() < grayscale_p:
        img = to_grayscale(img)
    if blur:
        h, w = img.shape[:2]
        kernel = int((0.1 * min(w, h) // 2 * 2) + 1)
        if rng.random() < 0.5:
            img = gaussian_blur(rng, img, kernel)
    return img


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8/float [H, W, 3] in [0,255] -> ImageNet-normalized float32."""
    mean = np.array(IMAGENET_MEAN, np.float32)
    std = np.array(IMAGENET_STD, np.float32)
    return ((img.astype(np.float32) / 255.0) - mean) / std


def normalize_device(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] in 0..255 -> ImageNet-normalized f32, same f32 math
    as ``sod_tpu``: (u8 / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=u8.device)
    return (u8.float() / 255.0 - mean) / std
