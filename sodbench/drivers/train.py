"""Training steps: the program's ``make_train_step`` (forward, criterion,
backward, ``ClippedAdamW``) built as the Trainer builds it, driven by
batches of seeded uint8 images, pseudo masks and labels uploaded from the
host each step, as the Trainer's loader hands them over.

Set-up runs the first ``checked_steps`` steps through the window's own call
and feed and keeps what the reference later checks: each step's loss, the
first step's gradient as AdamW received it (its first moment over 1 - b1)
and each parameter's change after those steps.  The window then goes on
stepping the same model and optimizer; it ends at the first step that
finishes enqueueing after ``seconds``, with a synchronize, and its rate is
the images of every step over that whole time.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import torch

from sodbench import flops, inputs
from sodbench.drivers.common import (free, load_libraries, program_config, rel_gap, sync,
                                     weights, leaf_gap)
from sodbench.reference.model import Arith, tf32_off
from sodbench.reference.train import train_steps

BATCH_STREAM = 100


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        self.t = ctx.traffic
        c = ctx.config["config"]
        self.arch = c["arch"]
        self.batch = c["batch_size"]
        self.size = c["train_image_size"]
        self.checked = self.t["checked_steps"]
        self.total_iters = c["n_epochs"] * math.ceil(self.t["train_images"] / self.batch)

    # -- inputs ---------------------------------------------------------
    def device_batch(self, i: int) -> Dict[str, torch.Tensor]:
        c = self.ctx.config["config"]
        g = inputs.generator(self.ctx.seed, BATCH_STREAM + i, self.dev)
        b, s = self.batch, self.size
        masks, valid = inputs.ellipse_masks(g, b, c["max_gt_masks"], s, s,
                                            tuple(self.t["masks_per_image"]), self.dev)
        return {"image": inputs.images(g, b, s, s, self.dev), "gt_masks": masks,
                "gt_valid": valid, "labels": inputs.labels(g, b, self.t["label_classes"], self.dev)}

    def _upload(self, i: int) -> Dict[str, torch.Tensor]:
        host = self.pool[i % len(self.pool)]
        return {k: torch.from_numpy(v).to(self.dev, non_blocking=True) for k, v in host.items()}

    # -- set-up ---------------------------------------------------------
    def setup(self, clock) -> None:
        with clock.phase("imports"):
            from sod_tpu_torch.models.maskformer import MaskFormer, config_from
            from sod_tpu_torch.train.optim import build_optimizer
            from sod_tpu_torch.train.step import make_train_step
            cfg = program_config(self.ctx)
        with clock.phase("ext_load"):
            load_libraries(self.ctx.config.get("libraries", []), self.dev)
        with clock.phase("weights"):
            model = MaskFormer(config_from(cfg)).to_empty(device=self.dev)
            model.load_state_dict(weights(self.ctx, self.dev))
            opt = build_optimizer(cfg, model.parameters(),
                                  n_iters_per_epoch=self.total_iters // cfg.n_epochs)
            self.model, self.opt = model, opt
            self.step = make_train_step(cfg, model, opt)
        with clock.phase("inputs"):
            self.pool = [{k: v.cpu().numpy() for k, v in self.device_batch(i).items()}
                         for i in range(self.t["pool_batches"])]
        with clock.phase("warmup"):
            self.prog = self._checked_steps()
        self.next = self.checked

    def _checked_steps(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        start = [p.detach().clone() for p in self.model.parameters()]
        losses, grads = [], None
        for i in range(self.checked):
            out = self.step(self._upload(i))
            losses.append(float(out["loss"]))
            if i == 0:
                b1 = self.opt.b1
                grads = dict(zip(names, torch.stack(
                    [(m / (1 - b1)).norm() for m in self.opt.mu]).tolist()))
        change = dict(zip(names, torch.stack(
            [(p.detach() - s).norm() for p, s in zip(self.model.parameters(), start)]).tolist()))
        sync(self.dev)
        return {"losses": losses, "grad": grads, "change": change}

    # -- the window -----------------------------------------------------
    def run_window(self, seconds: float) -> dict:
        spans = self.ctx.spans
        sync(self.dev)
        t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        self.losses = []
        while True:
            with spans.span("upload"):
                batch = self._upload(self.next)
            with spans.span("train_step"):
                out = self.step(batch)
            self.losses.append(out["loss"])
            self.next += 1
            if time.perf_counter_ns() >= deadline:
                break
        with spans.span("synchronize"):
            sync(self.dev)
        t1 = time.perf_counter_ns()
        self.window = {"t0_ns": t0, "t1_ns": t1}
        return self.window

    def counters(self) -> dict:
        steps = len(self.losses)
        c = self.ctx.config["config"]
        n = (self.size // c["patch_size"]) ** 2 + 1
        return {"kind": "train", "steps": steps, "images": steps * self.batch,
                "window_s": (self.window["t1_ns"] - self.window["t0_ns"]) / 1e9,
                "flops": steps * self.batch * flops.train_flops(self.arch, (self.size, self.size)),
                "k2_fwd_bound_s": flops.bound_s(*flops.k2_forward(self.batch, 6, n, 64)),
                "k2_bwd_bound_s": flops.bound_s(*flops.k2_backward(self.batch, 6, n, 64))}

    def attempted_failed(self):
        losses = torch.stack(self.losses).float().cpu()
        return len(losses), int((~torch.isfinite(losses)).sum())

    def release(self) -> None:
        for name in ("model", "opt", "step", "losses"):
            self.__dict__.pop(name, None)
        free(self.dev)

    # -- the check ------------------------------------------------------
    def reference(self, prec: str = "f32", keep_rows: float = 1.0) -> dict:
        """The reference's readings: f32 by default; ``fp8`` is the control,
        ``keep_rows`` < 1 the half-batch fault, each in the program's place."""
        with tf32_off():
            w = weights(self.ctx, self.dev)
            batches = [self.device_batch(i) for i in range(self.checked)]
            ref = train_steps(w, batches, self.ctx.config["config"], self.arch,
                              self.total_iters, Arith(prec), keep_rows)
            out = {"losses": ref["losses"],
                   "grad": {k: float(g.norm()) for k, g in ref["first_grad"].items()},
                   "change": {k: float((p - w[k]).norm()) for k, p in ref["params"].items()}}
        del w, batches, ref
        free(self.dev)
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> Dict[str, float]:
        """Each step's loss; the first gradient's norm by leaf, the worst
        leaf's gap and the median leaf's; the change's by the worst leaf,
        over leaves whose reference gradient is at least a thousandth of
        the median leaf's.  A cell's limits file says which it holds."""
        grads = sorted(ref["grad"].values())
        floor = 1e-3 * grads[len(grads) // 2]
        moved = {k for k, v in ref["grad"].items() if v >= floor}
        return {"loss_gap": max(rel_gap(a, b, abs(b)) for a, b in zip(prog["losses"], ref["losses"])),
                "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
                "grad_gap_median": leaf_gap(prog["grad"], ref["grad"], statistics.median),
                "change_gap": leaf_gap(prog["change"], ref["change"], keep=moved)}

    def readings(self) -> Dict[str, float]:
        return self.compare(self.prog, self.reference())

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        """The compared numbers of the program, of the control (the
        reference in fp8 in the program's place) and of the faults the cell
        can have: half of each batch left out; a state left unchanged."""
        ref = self.reference()
        still = {**self.prog, "change": {k: 0.0 for k in self.prog["change"]}}
        return {"program": self.compare(self.prog, ref),
                "control": self.compare(self.reference("fp8"), ref),
                "half_batch": self.compare(self.reference(keep_rows=0.5), ref),
                "unchanged": self.compare(still, ref)}
