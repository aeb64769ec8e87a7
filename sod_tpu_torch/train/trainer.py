"""Trainer of the port (twin of ``sod_tpu/train/trainer.py``), on one
device given explicitly.

Per epoch: the DUTS-TR loader (shuffled, threaded, padded collate), one
``train_step`` per batch (forward, criterion, backward, clip, AdamW with
the per-iteration poly schedule), the step metrics kept on the device and
fetched once at the end of the epoch, a ``metrics.jsonl`` record and the
``latest_model.pt`` checkpoint.  ``resume`` restores the model, optimizer,
iteration count and best-score trackers.

``Trainer(...)(n_epochs)`` trains and evaluates epoch by epoch.  After each
epoch ``_evaluate`` runs the canvas ``Evaluator`` on every
benchmark, logs the ``"iou (DUTS)"``-style metrics, keeps
``best_model_{name}.pt`` on an IoU improvement and writes the
``best_scores.json`` sidecar; a missing dataset is logged as skipped.

The Trainer builds either encoder and either head (``config_from``).  As
in ``sod_tpu``: with the non-bc head the Evaluator raises and the epoch's
evaluation with it; with the ResNet-50 the canvas forward refuses and each
benchmark is logged as skipped.

With ``cfg.async_checkpoint`` the ``latest_model.pt`` write overlaps the
next epoch (``AsyncSaver``: the state is copied to the host before
training goes on); ``wait_for_checkpoints`` blocks until it is on disk.
With a ``visualizer``, every ``len(loader) // 10`` iterations the current
weights' masks for the batch's first image are rendered
(``make_eval_step``, the fused encoder K1 in bf16).

Under a data mesh (``mesh``, or ``cfg.mesh_data_axis`` > 1; one process per
rank, ``parallel/mesh.py``) every rank builds the same model (broadcast from
rank 0), lays its state out by ``cfg.fsdp`` (``parallel.fsdp.StateLayout``:
``none``, ``zero1`` or ``full``) and decodes only its rows of each global
batch (``batch_sharding``; the augmentation draws per sample index, so they
are the single-device rows).  The step reduces the gradients and metrics
across the ranks (``train/step.py``), so every rank holds the same metrics;
the evaluation splits each batch across the ranks too.  Rank 0 writes the
files: ``metrics.jsonl``, ``config.json``, the checkpoints (the whole state,
gathered under any layout, so any layout resumes any other) and
``best_scores.json``.  Under ``full`` the visualizer's forward runs unfused
on the gathered weights, as in ``sod_tpu``.  ``fsdp`` without a mesh raises
``sod_tpu``'s error.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from sod_tpu_torch.config import Config, define_experim_name
from sod_tpu_torch.utils.profiling import StepTimer
from sod_tpu_torch.data.factory import get_dataset
from sod_tpu_torch.data.loader import DataLoader, collate_train
from sod_tpu_torch.metrics.average_meter import AverageMeter
from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
from sod_tpu_torch.parallel.fsdp import StateLayout, assert_fsdp_compatible
from sod_tpu_torch.parallel.mesh import (batch_sharding, data_group, data_size, is_main, make_mesh,
                                         replicated)
from sod_tpu_torch.train.checkpoints import AsyncSaver, restore_checkpoint, save_checkpoint
from sod_tpu_torch.train.evaluator import Evaluator
from sod_tpu_torch.train.logging import MetricLogger
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_eval_step, make_train_step

DEFAULT_BENCHMARKS = ["ecssd", "duts", "dut_omron"]
_PRETTY = {"duts": "DUTS", "ecssd": "ECSSD", "dut_omron": "DUT-OMRON"}


def train_dataset(cfg: Config):
    """The train split of ``cfg.dataset_name``, through ``get_dataset`` as
    ``sod_tpu``'s Trainer builds it, so a name without a train split raises
    the factory's error."""
    return get_dataset(cfg.dir_dataset, cfg.dataset_name, mode="train",
                       train_img_size=cfg.train_image_size,
                       scale_range=cfg.scale_range,
                       use_pseudo_masks=cfg.use_pseudo_masks,
                       pseudo_masks_fp=cfg.pseudo_masks_fp,
                       use_copy_paste=cfg.use_copy_paste)


class Trainer:
    def __init__(self, cfg: Config, device, state_dict=None, mcfg=None,
                 dataset=None, evaluator: Optional[Evaluator] = None,
                 visualizer=None, debug: bool = False, mesh=None):
        """:param device: the one device to train on ("cuda", "cpu", ...).
        :param state_dict: initial weights in the reference layout; seeded
            random weights (``random_state_dict(cfg.seed)``) otherwise.
        :param evaluator: an ``Evaluator`` to use after each epoch instead of
            building one; it is handed the Trainer's model (the current
            weights) before every evaluation, as ``sod_tpu``'s Trainer hands
            an injected evaluator its ``params``.
        :param visualizer: a ``utils.visualizer.Visualizer``, called with the
            batch and the current weights' last-layer outputs on its first
            image every ``len(loader) // 10`` iterations.
        :param mesh: a data mesh (``parallel.make_mesh``) to train over, this
            process being one of its ranks; else ``cfg.mesh_data_axis`` > 1
            makes one on ``device``.
        After each epoch the Trainer evaluates ``cfg.benchmarks`` (default
        ECSSD, DUTS-TE and DUT-OMRON)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.mcfg = mcfg or config_from(cfg)
        if mesh is None and cfg.mesh_data_axis > 1:
            mesh = make_mesh(cfg.mesh_data_axis, self.device)
        # sod_tpu's checks: fsdp needs a data axis > 1, full the plain path
        assert_fsdp_compatible(cfg, mesh)
        self.mesh = mesh
        self.is_main = is_main(mesh)
        accum = max(1, cfg.grad_accum_steps)
        # this rank's rows of every global batch (all of them without a mesh)
        self.rows = (batch_sharding(mesh, cfg.batch_size, accum)
                     if mesh is not None else None)
        self.debug = debug or cfg.debug
        self.benchmarks = cfg.benchmarks or DEFAULT_BENCHMARKS
        self.evaluator = evaluator
        self.visualizer = visualizer
        self._vis_step = None

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
        # every rank starts from rank 0's weights
        replicated(self.model, mesh)
        self.layout = (StateLayout(self.model, mesh, cfg.fsdp)
                       if mesh is not None else None)

        # ceil: the loader runs drop_last=False (padded collate)
        n_iters = max(1, -(-len(self.dataset) // cfg.batch_size))
        self.n_iters_per_epoch = n_iters
        self.optimizer = build_optimizer(
            cfg, self.model.parameters() if self.layout is None else self.layout.tensors,
            n_iters_per_epoch=n_iters)
        self.train_step = make_train_step(
            cfg, self.model, self.optimizer, accum_steps=accum,
            mode=cfg.grad_accum_mode, layout=self.layout)

        self._ckpt_saver = AsyncSaver() if cfg.async_checkpoint else None
        self.logger = MetricLogger(self.dir_ckpt, name=self.experim_name)
        self.n_iters_done = 0
        self.best_scores: Dict[str, float] = {}
        if self.is_main:
            cfg.dump_json(os.path.join(self.dir_ckpt, "config.json"))

    @property
    def latest_path(self) -> str:
        return os.path.join(self.dir_ckpt, "latest_model.pt")

    # ------------------------------------------------------------------
    def resume(self, path: Optional[str] = None) -> int:
        """Restore model, optimizer and counters from a checkpoint and
        return the next epoch to run."""
        self.wait_for_checkpoints()     # restore must see a finished write
        if self.mesh is not None:       # ... rank 0's
            dist.barrier(group=data_group(self.mesh))
        state = restore_checkpoint(path or self.latest_path,
                                   map_location=self.device)
        if self.layout is None:
            self.model.load_state_dict(state["model"])
            if "optimizer" in state:
                self.optimizer.load_state_dict(state["optimizer"])
        else:
            # a whole state, written under any layout, into this rank's share
            self.layout.load_full_state(state["model"], self.optimizer,
                                        state.get("optimizer"))
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
    def wait_for_checkpoints(self) -> None:
        """Block until an in-flight async checkpoint write is on disk (no-op
        under the default synchronous saves)."""
        if self._ckpt_saver is not None:
            self._ckpt_saver.wait()

    def _state(self):
        """(model state, optimizer state), whole: gathered on every rank under
        a mesh (collective), the objects themselves without one."""
        if self.layout is None:
            return self.model, self.optimizer
        return self.layout.full_state(self.optimizer)

    def _whole_weights(self):
        """The block runs with the whole weights in ``self.model`` (gathered
        and freed again under ``fsdp: full``; collective)."""
        if self.layout is None:
            return contextlib.nullcontext(self.model)
        return self.layout.gathered()

    def _visualize(self, num_epoch: int, it: int, batch: dict,
                   arrays: Dict[str, torch.Tensor]) -> None:
        """The visualizer hook on the batch's first image (ref trainer pyc
        134-164), rank 0's first row under a mesh; under ``fsdp: full`` the
        forward runs unfused on the gathered weights."""
        if self._vis_step is None:
            full = self.layout is not None and self.layout.level == "full"
            self._vis_step = make_eval_step(self.cfg, self.model, fused=not full)
        with self._whole_weights():
            if not self.is_main:
                return
            outs = self._vis_step(arrays["image"][:1])
        self.visualizer(num_epoch, it, batch,
                        outputs={k: v.cpu().numpy() for k, v in outs.items()})

    # ------------------------------------------------------------------
    def _train_epoch(self, num_epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.dataset.set_mode("train")
        self.dataset.use_data_augmentation_(True)
        local_b = cfg.batch_size // data_size(self.mesh)
        hw = (cfg.train_image_size, cfg.train_image_size)
        loader = DataLoader(
            self.dataset, batch_size=cfg.batch_size, shuffle=True,
            num_workers=cfg.num_workers, seed=cfg.seed, rows=self.rows,
            collate_fn=lambda s: collate_train(s, cfg.max_gt_masks, local_b, hw,
                                               self.dataset.train_u8))
        loader.set_epoch(num_epoch)

        timer = StepTimer()
        # per-step metrics stay on the device; one fetch at epoch end
        step_metrics: list = []
        vis_every = max(1, len(loader) // 10)
        for it, batch in enumerate(loader):
            timer.tick()
            arrays = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                      for k, v in batch.items() if k != "filename"}
            step_metrics.append(self.train_step(arrays))
            self.n_iters_done += 1
            if self.visualizer is not None and it % vis_every == 0:
                self._visualize(num_epoch, it, batch, arrays)
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
        model_state, opt_state = self._state()
        if self.is_main:
            self.logger.log(epoch_metrics, step=self.n_iters_done)
            save = self._ckpt_saver.save if self._ckpt_saver is not None else save_checkpoint
            save(self.latest_path, model_state, opt_state, epoch=num_epoch,
                 n_iters=self.n_iters_done, extra={"best_scores": dict(self.best_scores)})
        return epoch_metrics

    # ------------------------------------------------------------------
    def _evaluate(self, num_epoch: int) -> Dict[str, float]:
        """Evaluate every benchmark; keep the best model by IoU.  Under a mesh
        each batch is split across the ranks, which all get the metrics."""
        with self._whole_weights():
            return self._evaluate_whole(num_epoch)

    def _log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self.is_main:
            self.logger.log(metrics, step=step)

    def _evaluate_whole(self, num_epoch: int) -> Dict[str, float]:
        if self.evaluator is None:
            try:
                self.evaluator = Evaluator(self.model, self.cfg, self.mcfg,
                                           debug=self.debug, device=self.device,
                                           mesh=self.mesh)
            except FileNotFoundError as e:
                # no benchmark datasets on disk: skip, do not stop training
                self._log({"eval_skipped": "all", "reason": str(e)})
                return {}
        self.evaluator.model = self.model        # the current weights
        all_metrics: Dict[str, float] = {}
        for name in self.benchmarks:
            try:
                res = self.evaluator(
                    dataset_name=name,
                    dir_ckpt=os.path.join(self.dir_ckpt, "eval", name,
                                          f"{num_epoch:02d}"))
            except FileNotFoundError as e:
                self._log({"eval_skipped": name, "reason": str(e)})
                continue
            except ValueError as e:
                if self.mcfg.arch == "vit_small":
                    raise
                # the canvas forward runs the ViT only; sod_tpu's Trainer
                # logs the benchmark as skipped on its assertion
                self._log({"eval_skipped": name, "reason": str(e)})
                continue
            pretty = _PRETTY.get(name, name)
            all_metrics.update({f"{k} ({pretty})": v for k, v in res.items()})
            score = res["iou"]
            if score > self.best_scores.get(name, -1.0):
                self.best_scores[name] = score
                if self.is_main:
                    save_checkpoint(os.path.join(self.dir_ckpt, f"best_model_{name}.pt"),
                                    self.model, epoch=num_epoch, n_iters=self.n_iters_done)
        if all_metrics:
            self._log(all_metrics, step=self.n_iters_done)
        if self.best_scores and self.is_main:
            # post-eval tracker sidecar (see resume()); atomic replace
            fp = os.path.join(self.dir_ckpt, "best_scores.json")
            with open(fp + ".tmp", "w") as f:
                json.dump(self.best_scores, f)
            os.replace(fp + ".tmp", fp)
        return all_metrics

    # ------------------------------------------------------------------
    def __call__(self, n_epochs: Optional[int] = None, device=None,
                 start_epoch: int = 1) -> None:
        """Train then evaluate, once per epoch up to ``n_epochs`` (default
        ``cfg.n_epochs``), as ``sod_tpu``'s ``Trainer.__call__``.  ``device``
        is accepted for that signature and unused: the Trainer's device is
        its constructor's.  ``start_epoch`` is what ``resume()`` returned."""
        n_epochs = n_epochs or self.cfg.n_epochs
        for epoch in range(start_epoch, n_epochs + 1):
            metrics = self._train_epoch(epoch)
            if self.is_main:
                print(f"epoch {epoch}: loss {metrics['avg_loss']:.4f}, iou "
                      f"{metrics['avg_iou']:.4f}, grad_norm "
                      f"{metrics['avg_grad_norm']:.4f}", flush=True)
            self._evaluate(epoch)
