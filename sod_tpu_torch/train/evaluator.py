"""Canvas evaluation of the port (twin of ``sod_tpu/train/evaluator.py``),
on one device given explicitly.

Every image of a batch sits top-left in one fixed canvas (the dataset's
largest image, padded to the patch size); the model runs
``maskformer_apply_canvas`` (token-masked attention, per-image positional
embeddings, edge replication), which equals running each image at its own
size.  Masks come back to canvas resolution and every metric is a masked
reduction over the image's true (h, w) rectangle.  Per batch:

* default: the encoder's attention through K2's masked forward (under
  ``use_pallas_attention``), the x4 upsample of every query's mask as two
  f32 matmuls, the UB search on the canvas stack, then the F-max sweep K6;
* ``use_fused_eval``: the fused encoder (K1 up to 1024 tokens, else K5 and
  K4 per block), the UB counts from the low-res masks (K7), the upsample of
  the two chosen masks only, then K6.

Metrics stay on the device and are fetched once, after the last batch.
Keys, CSV header and rows and the returned dict (with the reference's
``pixel_accuarcy`` spelling) are ``sod_tpu``'s.  With a ``visualizer``, the
first image of every ``vis_every``-th batch is rendered from the last
layer's pre-upsample masks.

Under a data ``mesh`` (``parallel/mesh.py``, one process per rank) each
rank decodes and runs its rows of every canvas batch, and the per-image
metrics of every rank are gathered after each batch, so every rank returns
the single-device numbers, a short final batch included; rank 0 writes the
CSV and renders the visualizer's images.
"""
from __future__ import annotations

import functools
import json
import os
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.data.factory import get_dataset
from sod_tpu_torch.data.loader import DataLoader
from sod_tpu_torch.metrics.average_meter import AverageMeter
from sod_tpu_torch.metrics.batched import eval_batch_metrics, eval_batch_metrics_lowres
from sod_tpu_torch.models.maskformer import (MaskFormerConfig, config_from, maskformer_apply_canvas,
                                             require_vit_canvas)
from sod_tpu_torch.models.vit import pos_embed_canvas_device
from sod_tpu_torch.ops.resize import _resize_matrix, bilinear_separable
from sod_tpu_torch.parallel.mesh import (all_gather_into, batch_sharding, data_group, data_size,
                                         is_main,
                                         replicated)

_METRICS = ("f_measure", "f_max", "f_mean", "mae", "iou", "pixel_acc",
            "s_measure")
# the CSV's column order (evaluator pyc const 46)
_CSV_ORDER = ("iou", "pixel_acc", "f_measure", "f_max", "f_mean", "mae",
              "s_measure")
CSV_HEADER = ("iou,pixel_acc,f_score,f_max,f_mean,mae,s_measure,"
              "miou_ub,pixel_acc_ub,f_score_ub,f_max_ub,f_mean_ub,"
              "mae_ub,s_measure_ub\n")
COST_TYPES = ("iou", "f_measure", "f_max", "mae")


def host_pos_embed(table: np.ndarray, gh: int, gw: int,
                   pos_grid: int) -> np.ndarray:
    """torch-bicubic positional-embedding interpolation on the host.

    :param table: [1, pos_grid^2 + 1, D] learned table.
    :return: [1 + gh*gw, D] float32.
    """
    cls_pe, patch_pe = table[0, :1], table[0, 1:]
    d = table.shape[-1]
    if (gh, gw) == (pos_grid, pos_grid):
        return np.concatenate([cls_pe, patch_pe], 0).astype(np.float32)
    grid = patch_pe.reshape(pos_grid, pos_grid, d)
    mh = _resize_matrix(pos_grid, gh, "bicubic")
    mw = _resize_matrix(pos_grid, gw, "bicubic")
    out = np.einsum("Hh,hwd,Ww->HWd", mh, grid.astype(np.float32), mw)
    return np.concatenate([cls_pe, out.reshape(gh * gw, d)], 0)


def collate_canvas(samples, batch_size: int, canvas_hw, patch_size: int) -> dict:
    """Test samples (``return_raw``) -> one uint8 canvas batch: images and
    GT top-left in [batch_size, H, W] canvases, each image's patch grid
    ``grid_sizes`` and true size ``hw`` (1 x 1 for the padding rows)."""
    canvas_h, canvas_w = canvas_hw
    pad = lambda v: -(-v // patch_size) * patch_size  # noqa: E731
    image = np.zeros((batch_size, canvas_h, canvas_w, 3), np.uint8)
    gt = np.zeros((batch_size, canvas_h, canvas_w), np.uint8)
    grid_sizes = np.ones((batch_size, 2), np.int32)
    hw = np.ones((batch_size, 2), np.int32)
    for i, s in enumerate(samples):
        h, w = s["image_u8"].shape[:2]
        image[i, :h, :w] = s["image_u8"]
        gt[i, :h, :w] = s["masks"][0]
        grid_sizes[i] = (pad(h) // patch_size, pad(w) // patch_size)
        hw[i] = (h, w)
    return {"n": len(samples), "image": image, "gt": gt,
            "grid_sizes": grid_sizes, "hw": hw}


def canvas_inputs(model, image_u8: torch.Tensor, grid_sizes: torch.Tensor,
                  compute_dtype: torch.dtype):
    """The canvas forward's inputs on the device: the normalized images in
    ``compute_dtype``, the token mask [B, 1+N] (CLS and each image's grid)
    and the per-image positional embeddings [B, 1+N, D]."""
    p = model.cfg.vit.patch_size
    gh_c, gw_c = image_u8.shape[1] // p, image_u8.shape[2] // p
    gh, gw = grid_sizes[:, 0], grid_sizes[:, 1]
    patch_ok = ((torch.arange(gh_c, device=gh.device) < gh[:, None])[:, :, None]
                & (torch.arange(gw_c, device=gw.device) < gw[:, None])[:, None, :])
    token_mask = torch.cat([torch.ones_like(gh[:, None], dtype=torch.bool),
                            patch_ok.reshape(-1, gh_c * gw_c)], dim=1)
    pos_embed = pos_embed_canvas_device(model.encoder.pos_embed, gh, gw, (gh_c, gw_c))
    return normalize_device(image_u8).to(compute_dtype), token_mask, pos_embed


class Evaluator:
    """Evaluates a ``MaskFormer`` on the test benchmarks under ``dir_dataset``."""

    def __init__(self, model, cfg, mcfg: Optional[MaskFormerConfig] = None,
                 dir_dataset: Optional[str] = None, visualizer=None,
                 debug: bool = False, batch_size: int = 16, device=None,
                 vis_every: int = 250, mesh=None):
        """:param model: a ``MaskFormer`` (its weights are used as they are,
            its parameters are not changed).
        :param visualizer: a ``utils.visualizer.Visualizer`` (its
            ``eval_grid``), called every ``vis_every`` batches (ref
            evaluator pyc 240-269 renders grids every 250 batches).
        :param device: where evaluation runs (default: the model's device).
        :param mesh: a data mesh (``parallel.make_mesh``) whose ranks split
            every batch; the model's weights are broadcast from rank 0."""
        self.model = model
        self.visualizer = visualizer
        self.vis_every = max(1, vis_every)
        self.cfg = cfg
        self.mcfg = mcfg or config_from(cfg)
        if not self.mcfg.use_binary_classifier:
            # sod_tpu's check and message (train/evaluator.py:83-92)
            raise ValueError(
                "Evaluator requires use_binary_classifier=True: selection "
                "is argmax objectness (ref evaluator pyc 219-221) and the "
                "non-bc forward has no objectness head — unsupported in "
                "the reference as well (docs/PARITY.md)")
        self.dir_dataset = dir_dataset or cfg.dir_dataset
        if not os.path.isdir(self.dir_dataset):
            raise FileNotFoundError(self.dir_dataset)
        self.debug = debug
        self.batch_size = batch_size
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.mesh = mesh
        self._n_data = data_size(mesh)
        self._check_batch(batch_size)
        replicated(model, mesh)
        self._canvas_cache: Dict = {}

    def _check_batch(self, batch_size: int) -> None:
        """Every rank needs as many rows (``sod_tpu``'s check and message)."""
        if self.mesh is not None and batch_size % self._n_data != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh's data "
                f"axis ({self._n_data})")

    def _max_image_size(self, dataset, dataset_name, img_size):
        """Max (h, w) over the dataset's images, computed once per dataset:
        cached in memory and in ``.sod_canvas_cache.json`` beside the
        dataset (``sod_tpu``'s file and keys: the filename list's crc32 and
        the newest mtime, so a regenerated dataset is scanned again)."""
        names_crc = zlib.crc32("|".join(dataset.p_imgs).encode())
        try:
            newest = int(max(os.path.getmtime(fp) for fp in dataset.p_imgs))
        except OSError:
            newest = 0
        key = (dataset_name, int(img_size or 0), len(dataset), names_crc, newest)
        if key in self._canvas_cache:
            return self._canvas_cache[key]
        cache_fp = os.path.join(self.dir_dataset, ".sod_canvas_cache.json")
        file_key = ":".join(map(str, key))
        persisted = {}
        try:
            with open(cache_fp) as f:
                persisted = json.load(f)
        except (OSError, ValueError):
            pass
        if file_key in persisted:
            hw = tuple(persisted[file_key])
        else:
            from PIL import Image

            max_h = max_w = 1
            for fp in dataset.p_imgs:
                with Image.open(fp) as im:
                    w, h = im.size
                max_h, max_w = max(max_h, h), max(max_w, w)
            hw = (max_h, max_w)
            persisted[file_key] = hw
            try:
                with open(cache_fp, "w") as f:
                    json.dump(persisted, f)
            except OSError:
                pass               # read-only dataset dir: memory still holds
        self._canvas_cache[key] = hw
        return hw

    def _step(self, scale_factor: int, image_u8, gt_u8, grid_sizes, sizes,
              cost_type: str, vis: bool = False):
        """One canvas batch on the device: ({metric: [B]}, the visualizer's
        payload or None).  ``vis``: also return the last layer's
        pre-upsample masks as uint8 [B, Q, sG, sG] and the objectness."""
        require_vit_canvas(self.mcfg)
        compute = (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                   else torch.float32)
        image, token_mask, pos_embed = canvas_inputs(self.model, image_u8, grid_sizes,
                                                     compute)
        fused = getattr(self.cfg, "use_fused_eval", False)
        out = maskformer_apply_canvas(self.model, image, token_mask, pos_embed,
                                      grid_sizes, fused=fused,
                                      scale_factor=scale_factor, last_layer_only=True)
        gt = gt_u8.float()
        masks = out["mask_pred"][:, -1].float()                       # [B, Q, sG, sG]
        obj = out["objectness"][:, -1, :, 0].float()
        payload = None
        if vis:
            payload = {"masks_u8": (masks.clamp(0.0, 1.0) * 255.0).to(torch.uint8),
                       "objectness": obj}
        if fused:
            return eval_batch_metrics_lowres(masks, obj, gt, sizes, cost_type), payload
        up = self.mcfg.vit.patch_size // scale_factor   # x4 at scale_factor 2
        masks = bilinear_separable(masks, masks.shape[-2] * up, masks.shape[-1] * up)
        return eval_batch_metrics(masks, obj, gt, sizes, cost_type), payload

    def _visualize(self, dataset_name: str, bi: int, batch: dict, vis: dict,
                   scale_factor: int) -> None:
        """Render the first image of a batch, cropped to its valid region
        (ref evaluator pyc 240-269)."""
        masks_u8 = vis["masks_u8"][0].cpu().numpy()                 # [Q, sG, sG]
        obj = vis["objectness"][0].cpu().numpy()
        h, w = (int(v) for v in batch["hw"][0])
        gh, gw = (int(v) for v in batch["grid_sizes"][0])
        s = scale_factor
        preds = masks_u8[:, :s * gh, :s * gw].astype(np.float32) / 255.0
        self.visualizer.eval_grid(batch["image"][0][:h, :w], batch["gt"][0][:h, :w],
                                  preds, obj, os.path.join(dataset_name, f"{bi:05d}.png"))

    def __call__(self, dataset_name: str, dir_ckpt: Optional[str] = None,
                 img_size: Optional[int] = None, scale_factor: int = 2,
                 batch_size: Optional[int] = None,
                 cost_type: str = "iou") -> Dict[str, float]:
        """Evaluate one benchmark on the evaluator's device; writes
        ``metrics_{dataset_name}.txt`` (a CSV row per image) under
        ``dir_ckpt`` and returns the means.

        :param scale_factor: the pixel decoder's upsample factor (a plain
            bilinear resize, so it may differ from training's); it must
            divide the patch size, and the masks return to canvas size with
            the complementary ``patch_size // scale_factor``.
        """
        p = self.mcfg.vit.patch_size
        if scale_factor < 1 or p % scale_factor != 0:
            raise ValueError(f"scale_factor must divide the patch size ({p}); "
                             f"got {scale_factor}")
        if cost_type not in COST_TYPES:
            raise ValueError(cost_type)
        cfg = self.cfg
        batch_size = batch_size or self.batch_size
        self._check_batch(batch_size)
        dataset = get_dataset(self.dir_dataset, dataset_name, mode="test",
                              eval_img_size=img_size or cfg.eval_image_size)
        if len(dataset) == 0:
            raise FileNotFoundError(
                f"no test images for {dataset_name} under {self.dir_dataset}")

        max_h, max_w = self._max_image_size(dataset, dataset_name,
                                            img_size or cfg.eval_image_size)
        pad = lambda v: -(-v // p) * p  # noqa: E731
        dataset.return_raw = True
        local_b = batch_size // self._n_data
        collate = functools.partial(collate_canvas, batch_size=local_b,
                                    canvas_hw=(pad(max_h), pad(max_w)), patch_size=p)
        loader = DataLoader(
            dataset, batch_size=batch_size, shuffle=False, num_workers=cfg.num_workers,
            collate_fn=collate,
            rows=None if self.mesh is None else batch_sharding(self.mesh, batch_size))
        keys = [*_METRICS, *(f"{k}_ub" for k in _METRICS)]
        pending = []                        # (n, [B, 14] metrics on the device)
        with torch.inference_mode():
            for bi, batch in enumerate(loader):
                arrays = [torch.from_numpy(batch[k]).to(self.device, non_blocking=True)
                          for k in ("image", "gt", "grid_sizes", "hw")]
                vis = (self.visualizer is not None and bi % self.vis_every == 0
                       and is_main(self.mesh))
                metrics, payload = self._step(scale_factor, *arrays, cost_type, vis=vis)
                table = torch.stack([metrics[k].float() for k in keys], dim=1)
                if self.mesh is not None:
                    # every rank's rows, in the batch's order
                    whole = table.new_empty((batch_size, len(keys)))
                    all_gather_into(whole, table, group=data_group(self.mesh))
                    table = whole
                pending.append((min(batch_size, len(dataset) - bi * batch_size), table))
                if vis:
                    self._visualize(dataset_name, bi, batch, payload, scale_factor)
                if self.debug:
                    break

        meters = {k: AverageMeter() for k in _METRICS}
        meters.update({f"{k}_ub": AverageMeter() for k in _METRICS})
        rows = []
        for n, table in pending:
            host = dict(zip(keys, table.cpu().t().tolist()))
            for i in range(n):
                for k in keys:
                    meters[k].update(host[k][i], 1)
                rows.append([host[k][i] for k in _CSV_ORDER]
                            + [host[f"{k}_ub"][i] for k in _CSV_ORDER])

        if dir_ckpt is not None and is_main(self.mesh):
            os.makedirs(dir_ckpt, exist_ok=True)
            with open(os.path.join(dir_ckpt, f"metrics_{dataset_name}.txt"), "w") as f:
                f.write(CSV_HEADER)
                for r in rows:
                    f.write(",".join(f"{v:.6f}" for v in r) + "\n")

        return {
            "iou": meters["iou"].avg,
            "pixel_accuarcy": meters["pixel_acc"].avg,
            "f_score": meters["f_measure"].avg,
            "f_max": meters["f_max"].avg,
            "f_mean": meters["f_mean"].avg,
            "mae": meters["mae"].avg,
            "s_measure": meters["s_measure"].avg,
            "iou_ub": meters["iou_ub"].avg,
            "pixel_accuarcy_ub": meters["pixel_acc_ub"].avg,
            "f_score_ub": meters["f_measure_ub"].avg,
            "f_max_ub": meters["f_max_ub"].avg,
            "f_mean_ub": meters["f_mean_ub"].avg,
            "mae_ub": meters["mae_ub"].avg,
            "s_measure_ub": meters["s_measure_ub"].avg,
        }


def salient_mask_index(pred_masks, h=None, w=None) -> int:
    """GT-free mask selection by IoU voting among the filtered query masks
    (ref evaluator pyc ``_get_salient_mask``; the live evaluator selects by
    objectness instead).

    :param pred_masks: [Q, H, W] sigmoid masks (numpy or a tensor).
    :param h, w: the image's true size inside a canvas.
    :return: index of the query agreeing most with the others.
    """
    from sod_tpu_torch.data.mask_generator import vote_mask
    from sod_tpu_torch.utils.misc import filter_masks

    binary = (np.asarray(pred_masks) > 0.5).astype(np.uint8)
    if h is not None:
        binary = binary[:, :h, :w]
    filtered, mapping = filter_masks(binary, remove_long_masks=True,
                                     remove_small_large_masks=False)
    winner = vote_mask(filtered)
    return mapping.get(winner, winner)
