"""Trainer of the port (twin of ``sod_tpu/train/trainer.py``), on one
device given explicitly.

Per epoch: the DUTS-TR loader (shuffled, threaded, padded collate), one
``train_step`` per batch (forward, criterion, backward, clip, AdamW with
the per-iteration poly schedule), the step metrics kept on the device and
fetched once at the end of the epoch, a ``metrics.jsonl`` record and the
``latest_model.pt`` checkpoint.  ``resume`` restores the model, optimizer,
iteration count and best-score trackers.

Not ported here: meshes (ROADMAP item 12), the visualizer and async
checkpoints (item 6), and evaluation: canvas evaluation is ROADMAP item 7,
so ``_evaluate`` logs the record ``sod_tpu`` writes when it cannot
evaluate and writes no ``best_model``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from sod_tpu.config import Config, define_experim_name
from sod_tpu.utils.profiling import StepTimer
from sod_tpu_torch.data.duts import DUTSDataset
from sod_tpu_torch.data.loader import DataLoader, collate_train
from sod_tpu_torch.metrics.average_meter import AverageMeter
from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
from sod_tpu_torch.train.checkpoints import restore_checkpoint, save_checkpoint
from sod_tpu_torch.train.logging import MetricLogger
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step

EVAL_SKIPPED = ("canvas evaluation is not ported to sod_tpu_torch "
                "(ROADMAP item 7)")


def train_dataset(cfg: Config) -> DUTSDataset:
    """The DUTS-TR train split (``get_dataset(..., "duts", mode="train")``)."""
    if cfg.dataset_name != "duts":
        raise NotImplementedError(
            f"dataset {cfg.dataset_name!r}: the port trains on duts only")
    ds = DUTSDataset(os.path.join(cfg.dir_dataset, "DUTS"),
                     img_size=cfg.train_image_size, scale_range=cfg.scale_range,
                     use_pseudo_masks=cfg.use_pseudo_masks,
                     pseudo_masks_fp=cfg.pseudo_masks_fp,
                     use_copy_paste=cfg.use_copy_paste)
    ds.set_mode("train")
    return ds


class Trainer:
    def __init__(self, cfg: Config, device, state_dict=None, mcfg=None,
                 dataset=None, debug: bool = False):
        """:param device: the one device to train on ("cuda", "cpu", ...).
        :param state_dict: initial weights in the reference layout; seeded
            random weights (``random_state_dict(cfg.seed)``) otherwise."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.mcfg = mcfg or config_from(cfg)
        self.debug = debug or cfg.debug

        self.experim_name = define_experim_name(cfg)
        self.dir_ckpt = os.path.join(cfg.dir_ckpt, self.experim_name)
        os.makedirs(self.dir_ckpt, exist_ok=True)

        self.dataset = dataset if dataset is not None else train_dataset(cfg)
        # ship augmented images as uint8, normalized on the device
        self.dataset.train_u8 = getattr(cfg, "train_ship_uint8", True)
        # augmentation draws key off [dataset.seed, epoch, index]
        self.dataset.seed = cfg.seed

        self.model = MaskFormer(self.mcfg)
        self.model.load_state_dict(state_dict if state_dict is not None
                                   else random_state_dict(self.model, cfg.seed))
        self.model.to(self.device)

        # ceil: the loader runs drop_last=False (padded collate)
        n_iters = max(1, -(-len(self.dataset) // cfg.batch_size))
        self.n_iters_per_epoch = n_iters
        self.optimizer = build_optimizer(cfg, self.model.parameters(),
                                         n_iters_per_epoch=n_iters)
        self.train_step = make_train_step(
            cfg, self.model, self.optimizer,
            accum_steps=max(1, cfg.grad_accum_steps), mode=cfg.grad_accum_mode)

        self.logger = MetricLogger(self.dir_ckpt, name=self.experim_name)
        self.n_iters_done = 0
        self.best_scores: Dict[str, float] = {}
        cfg.dump_json(os.path.join(self.dir_ckpt, "config.json"))

    @property
    def latest_path(self) -> str:
        return os.path.join(self.dir_ckpt, "latest_model.pt")

    # ------------------------------------------------------------------
    def resume(self, path: Optional[str] = None) -> int:
        """Restore model, optimizer and counters from a checkpoint and
        return the next epoch to run."""
        state = restore_checkpoint(path or self.latest_path,
                                   map_location=self.device)
        self.model.load_state_dict(state["model"])
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.n_iters_done = int(state.get("n_iters", 0))
        best = (state.get("extra") or {}).get("best_scores") or {}
        self.best_scores.update({k: float(v) for k, v in best.items()})
        # the post-eval tracker sidecar, newer than latest_model's copy
        fp = os.path.join(self.dir_ckpt, "best_scores.json")
        if os.path.isfile(fp):
            with open(fp) as f:
                for k, v in json.load(f).items():
                    if float(v) > self.best_scores.get(k, -1.0):
                        self.best_scores[k] = float(v)
        return int(state.get("epoch", 0)) + 1

    # ------------------------------------------------------------------
    def _train_epoch(self, num_epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.dataset.set_mode("train")
        self.dataset.use_data_augmentation_(True)
        loader = DataLoader(
            self.dataset, batch_size=cfg.batch_size, shuffle=True,
            num_workers=cfg.num_workers, seed=cfg.seed,
            collate_fn=lambda s: collate_train(s, cfg.max_gt_masks,
                                               cfg.batch_size))
        loader.set_epoch(num_epoch)

        timer = StepTimer()
        # per-step metrics stay on the device; one fetch at epoch end
        step_metrics: list = []
        for batch in loader:
            timer.tick()
            arrays = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                      for k, v in batch.items() if k != "filename"}
            step_metrics.append(self.train_step(arrays))
            self.n_iters_done += 1
            if self.debug:
                break

        meters = {k: AverageMeter() for k in METRIC_KEYS}
        host = {k: torch.stack([m[k].float() for m in step_metrics]).cpu().tolist()
                for k in METRIC_KEYS}
        for k, m in meters.items():
            for v in host[k]:
                m.update(v, 1)
        epoch_metrics = {f"avg_{k}": m.avg for k, m in meters.items()}
        epoch_metrics["epoch"] = num_epoch
        epoch_metrics["images_per_second"] = timer.images_per_second(
            cfg.batch_size)
        self.logger.log(epoch_metrics, step=self.n_iters_done)
        save_checkpoint(self.latest_path, self.model, self.optimizer,
                        epoch=num_epoch, n_iters=self.n_iters_done,
                        extra={"best_scores": dict(self.best_scores)})
        return epoch_metrics

    # ------------------------------------------------------------------
    def _evaluate(self, num_epoch: int) -> Dict[str, float]:
        """Canvas evaluation is not ported: log the skip, as ``sod_tpu``
        does when it cannot evaluate, and keep no ``best_model``."""
        self.logger.log({"eval_skipped": "all", "reason": EVAL_SKIPPED,
                         "epoch": num_epoch})
        return {}
