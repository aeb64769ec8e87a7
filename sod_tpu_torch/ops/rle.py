"""COCO-compatible RLE mask codec of the port (twin of ``sod_tpu/ops/rle.py``:
pure NumPy with ``sod_tpu.native``'s jax-free C++ fast path).

The reference depends on ``pycocotools.mask.encode/decode`` (C) for the
pseudo-mask JSON (``datasets/duts.py:11,100-106``; mask_generator pyc).  The
on-disk format must stay bit-compatible so the shipped
``swav_mocov2_dino_p16_k234.json`` loads unchanged:

* runs are counted in Fortran (column-major) order, alternating 0s/1s,
  starting with the count of 0s;
* the ``counts`` string is COCO's LEB128-like base-32 varint stream with
  delta coding from the count two positions back (``x -= cnts[i-2]`` for
  i > 2), 5 bits per char, continuation bit 0x20, chars offset by 48.

``encode``/``decode`` mirror pycocotools' dict shape:
``{"size": [h, w], "counts": str}``.

When the native library (``sod_tpu/native``) is built, run-length extraction
and expansion route through C++; the NumPy fallback is pure vectorised code.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from sod_tpu import native as _native


def _counts_from_mask(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths, starting with a (possibly 0) run of 0s."""
    nat = _native.counts_from_mask(np.asarray(mask, np.uint8))
    if nat is not None:
        return nat
    # binarize exactly like the native path / pycocotools (any nonzero
    # pixel is foreground) — a {0,255} mask must not invert or split runs
    flat = (np.asarray(mask).flatten(order="F") != 0).astype(np.uint8)
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    runs = ends - starts
    if flat[0] != 0:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def _mask_from_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    if len(counts) and int(counts.min()) < 0:
        # must reject BEFORE the native path: negative counts that still
        # sum to h*w would drive the C++ expansion loop out of bounds
        raise ValueError("RLE counts must be non-negative")
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")
    nat = _native.mask_from_counts(counts, h, w)
    if nat is not None:
        return nat
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F")


def _leb_encode(counts: np.ndarray) -> str:
    """COCO string encoding (pycocotools rleToString)."""
    nat = _native.string_from_counts(counts)
    if nat is not None:
        return nat
    out: List[str] = []
    cnts = counts.tolist()
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _leb_decode(s: Union[str, bytes]) -> np.ndarray:
    """COCO string decoding (pycocotools rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    nat = _native.counts_from_string(s)
    if nat is not None:
        return nat
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


def encode(mask: np.ndarray) -> Union[Dict, List[Dict]]:
    """Encode a binary mask [H, W] (or stack [H, W, N]) to COCO RLE dict(s),
    matching ``pycocotools.mask.encode`` output shape."""
    if mask.ndim == 3:
        return [encode(mask[..., i]) for i in range(mask.shape[-1])]
    h, w = mask.shape
    counts = _counts_from_mask(mask)
    return {"size": [int(h), int(w)], "counts": _leb_encode(counts)}


def decode(rle: Union[Dict, List[Dict]]) -> np.ndarray:
    """Decode COCO RLE dict(s) to [H, W] (or [H, W, N]) uint8, matching
    ``pycocotools.mask.decode``.  Accepts uncompressed ``counts`` lists
    too."""
    if isinstance(rle, list):
        return np.stack([decode(r) for r in rle], axis=-1)
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        arr = np.asarray(counts, np.int64)
    else:
        arr = _leb_decode(counts)
    return _mask_from_counts(arr, h, w)


def area(rle: Dict) -> int:
    counts = rle["counts"]
    arr = (np.asarray(counts, np.int64) if isinstance(counts, (list, tuple))
           else _leb_decode(counts))
    return int(arr[1::2].sum())


def iou(rle_a: Dict, rle_b: Dict) -> float:
    a, b = decode(rle_a).astype(bool), decode(rle_b).astype(bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0
