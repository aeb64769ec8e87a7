"""Spectral-cluster-voting pseudo-mask generation of the port (twin of
``sod_tpu/data/mask_generator.py``; SURVEY §2.8, §3.4).

Per image:

1. self-supervised features of every backbone (``dino``: ViT-S layer-12
   patch tokens; ``mocov2`` / ``swav``: dilated-8 ResNet-50 res5);
2. the feature grid upsampled bilinearly by ``scale_factor``;
3. for every k in ``cluster_sizes``: spectral (or k-means) clustering of the
   feature nodes, one eigenbasis for all k;
4. the label grids upsampled (nearest) to the image, one binary candidate
   per (backbone, k, cluster); ``filter_masks`` drops degenerate ones;
5. the vote: the candidate with the highest summed IoU against the others;
6. its COCO RLE, ``{filename: rle}`` JSON (what ``DUTSDataset`` reads).

Steps 1-3 run on ``device`` per batch (the uint8 batch uploaded once and
normalised there, f32 with TF32 off, one affinity matrix alive at a time);
only the [B, G, G] label grids come back.  Steps 4-6 are host NumPy, run on
a worker thread while the main thread queues the next batch.
"""
from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.data.clusterings import kmeans, spectral_cluster_multi
from sod_tpu_torch.data.custom import CustomDataset
from sod_tpu_torch.data.loader import DataLoader
from sod_tpu_torch.ops import rle as rle_codec
from sod_tpu_torch.ops.resize import bilinear_separable, interpolate_nearest
from sod_tpu_torch.utils.misc import filter_masks


def vote_mask(candidates: np.ndarray) -> int:
    """Index of the candidate agreeing most with the others (pairwise-IoU
    voting, ref mask_generator pyc ``vote_mask``), copied from ``sod_tpu``.

    The pairwise counts come from one gram matmul on the 0/1 masks
    (``inter = F F^T``, ``union = area_i + area_j - inter``), exact in f32
    (integer counts below 2^24)."""
    n = len(candidates)
    if n == 1:
        return 0
    flat = (candidates.reshape(n, -1) != 0).astype(np.float32)
    inter = flat @ flat.T                          # [n, n] exact counts
    area = inter.diagonal()                        # |A_i|
    union = area[:, None] + area[None, :] - inter
    iou = inter / np.maximum(union, 1)
    np.fill_diagonal(iou, 0.0)
    return int(np.argmax(iou.sum(-1)))


@contextlib.contextmanager
def f32_math():
    """Full-f32 matmuls and convolutions on the card for the block (cuDNN
    runs f32 convolutions in TF32 by default); the flags are restored."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class MaskGenerator:
    """ref ``MaskGenerator.__init__(cluster_sizes, cluster_type,
    feature_types, use_gpu, device)``."""

    def __init__(self, cluster_sizes: Sequence[int] = (2, 3, 4),
                 cluster_type: str = "spectral",
                 feature_types: Sequence[str] = ("mocov2", "swav", "dino"),
                 use_gpu: bool = True, device=None, patch_size: int = 16,
                 image_size: int = 224, scale_factor: int = 2, batch_size: int = 16,
                 seed: int = 0, params: Optional[Dict[str, dict]] = None, mesh=None):
        """:param device: where features and clustering run; the card
            (``"cuda"``) unless given.  ``use_gpu`` is the reference's and
            unused.
        :param params: {feature type: torch state dict} of the backbones
            (``models.convert.convert_vit`` / ``convert_resnet50`` keys);
            the others get seeded random weights (``_get_params``).
        :param mesh: data-parallel sharding is ROADMAP item 12 and raises."""
        if cluster_type not in ("spectral", "k-means"):
            raise ValueError(f"cluster_type {cluster_type!r}: spectral or k-means")
        if mesh is not None:
            raise NotImplementedError(
                "mesh is not ported to sod_tpu_torch (ROADMAP item 12, the "
                "parallel layouts); the port generates masks on one device")
        self.cluster_sizes = list(cluster_sizes)
        self.cluster_type = cluster_type
        self.feature_types = list(feature_types)
        self.device = torch.device(device if device is not None else "cuda")
        self.patch_size = patch_size
        self.image_size = image_size
        self.scale_factor = scale_factor
        self.batch_size = batch_size
        self.seed = seed
        self._params = dict(params or {})
        self._models: Dict[str, torch.nn.Module] = {}

    # ------------------------------------------------------------------
    def _get_params(self, feature_type: str) -> torch.nn.Module:
        """The backbone of ``feature_type`` on the device, f32, from its
        given state dict, else with seeded random weights drawn with numpy
        (``models.vit.random_vit_state_dict``, ``models.resnet.resnet50_init``:
        ``sod_tpu``'s distributions, not its ``jax.random`` values; tests
        give both packages the same converted weights instead)."""
        if feature_type not in self._models:
            if feature_type == "dino":
                from sod_tpu_torch.models.vit import (
                    VisionTransformer,
                    random_vit_state_dict,
                    vit_small,
                )

                model = VisionTransformer(vit_small(patch_size=self.patch_size))
                model.load_state_dict(self._params.get(feature_type)
                                      or random_vit_state_dict(model, self.seed))
            else:
                from sod_tpu_torch.models.resnet import resnet50_init

                model = resnet50_init(self.seed)
                if feature_type in self._params:
                    model.load_state_dict(self._params[feature_type])
            self._models[feature_type] = model.to(self.device).float().eval()
        return self._models[feature_type]

    def features(self, feature_type: str, u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] on the device -> upsampled features [B, G, G, D]."""
        model = self._get_params(feature_type)
        x = normalize_device(u8)
        s = self.scale_factor
        if feature_type == "dino":
            from sod_tpu_torch.models.vit import vit_apply

            grid = self.image_size // self.patch_size
            tokens = vit_apply(model, x)[:, 1:]                   # layer-12 patches
            f = tokens.reshape(len(x), grid, grid, -1).permute(0, 3, 1, 2)
        else:
            from sod_tpu_torch.models.resnet import resnet_forward

            f = resnet_forward(model, x.permute(0, 3, 1, 2))["res5"]
        f = bilinear_separable(f, f.shape[-2] * s, f.shape[-1] * s)
        return f.permute(0, 2, 3, 1)

    def cluster(self, feats: torch.Tensor, eigh_max_n: Optional[int] = None
                ) -> Dict[int, torch.Tensor]:
        """Features [B, G, G, D] -> {k: labels [B, G, G] int32}."""
        b, gh, gw, d = feats.shape
        flat = feats.reshape(b, gh * gw, d)
        ks = tuple(self.cluster_sizes)
        if self.cluster_type == "spectral":
            labels = spectral_cluster_multi(flat, ks, seed=self.seed, eigh_max_n=eigh_max_n)
        else:
            labels = tuple(kmeans(flat, k, seed=self.seed) for k in ks)
        return {k: lab.reshape(b, gh, gw).to(torch.int32) for k, lab in zip(ks, labels)}

    def _extract_cluster_fn(self, feature_type: str):
        """uint8 batch on the device -> {k: labels [B, G, G]}, f32 math,
        the backbone's affinity matrix freed before it returns."""
        def run(u8: torch.Tensor) -> Dict[int, torch.Tensor]:
            with torch.inference_mode(), f32_math():
                return self.cluster(self.features(feature_type, u8))
        return run

    def _upsample_labels(self, lab: np.ndarray) -> np.ndarray:
        """Nearest-upsample a [G_h, G_w] label grid to the image size on the
        host: ``np.repeat`` for integer factors (torch's nearest source
        index floor(dst * G / S) is dst // factor there), else
        ``interpolate_nearest``."""
        gh, gw = lab.shape
        S = self.image_size
        fh, fw = S // gh, S // gw
        if fh * gh == S and fw * gw == S:
            return np.repeat(np.repeat(lab, fh, axis=0), fw, axis=1)
        return interpolate_nearest(torch.from_numpy(lab), S, S).numpy()

    def _label_batches(self, p_images: List[str]):
        """Yield ``(samples, {(feature type, k): [n, G, G] labels})`` per
        batch; batch i + 1's device work is queued before batch i's labels
        are fetched."""
        ds = CustomDataset(p_images, image_size=self.image_size, square=True,
                           raw_uint8=True)
        loader = DataLoader(ds, batch_size=self.batch_size, shuffle=False, num_workers=4)
        fns = {ft: self._extract_cluster_fn(ft) for ft in self.feature_types}

        def fetch(pending):
            samples, results = pending
            return samples, {(ft, k): results[ft][k][:len(samples)].cpu().numpy()
                             for ft in self.feature_types for k in self.cluster_sizes}

        pending = None
        for samples in loader:
            arr = np.stack([s["image_u8"] for s in samples])
            if len(arr) < self.batch_size:
                # the ragged final batch, wrap-padded to the full batch (every
                # batch has one shape); fetch trims the copies
                arr = np.concatenate([arr, arr[-1:].repeat(self.batch_size - len(arr), 0)])
            u8 = torch.from_numpy(arr).to(self.device)
            results = {ft: fns[ft](u8) for ft in self.feature_types}
            if pending is not None:
                yield fetch(pending)
            pending = (samples, results)
        if pending is not None:
            yield fetch(pending)

    def _candidates(self, labels: dict, i: int) -> np.ndarray:
        """[n_candidates, S, S] uint8: one mask per (backbone, k, cluster)."""
        cands: List[np.ndarray] = []
        for ft in self.feature_types:
            for k in self.cluster_sizes:
                up = self._upsample_labels(labels[(ft, k)][i])
                cands.extend((up == c).astype(np.uint8) for c in range(k))
        return np.stack(cands, 0)

    def _iter_candidate_stacks(self, p_images: List[str]):
        """Yield ``(p_img, [n_candidates, H, W] uint8)`` per image."""
        for samples, labels in self._label_batches(p_images):
            for i, smp in enumerate(samples):
                yield smp["p_img"], self._candidates(labels, i)

    # ------------------------------------------------------------------
    def extract_candidate_masks(self, p_images: List[str]) -> Dict[str, np.ndarray]:
        """full path -> [n_candidates, H, W] uint8 candidate stacks (by full
        path: images sharing a basename do not vote across each other)."""
        return dict(self._iter_candidate_stacks(p_images))

    def _vote_one(self, stack: np.ndarray) -> np.ndarray:
        filtered, _ = filter_masks(stack, remove_long_masks=True,
                                   remove_small_large_masks=True)
        return filtered[vote_mask(filtered)]

    def _vote_batch(self, samples, labels) -> List[tuple]:
        return [(os.path.basename(smp["p_img"]),
                 rle_codec.encode(self._vote_one(self._candidates(labels, i)).astype(np.uint8)))
                for i, smp in enumerate(samples)]

    def __call__(self, p_images: List[str]) -> Dict[str, dict]:
        """``{filename: COCO RLE}`` for a list of image paths, in their
        order.  A worker thread builds, filters, votes and encodes each
        batch's candidates while the next batch runs on the device."""
        out = {}
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = [pool.submit(self._vote_batch, samples, labels)
                       for samples, labels in self._label_batches(p_images)]
            for fut in futures:
                out.update(fut.result())
        return out

    def dump(self, p_images: List[str], fp: str) -> None:
        with open(fp, "w") as f:
            json.dump(self(p_images), f)
