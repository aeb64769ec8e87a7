"""Training steps of SelfMask nq20 on DINOv2's ViT-g/14 with registers: the
``train`` driver's steps, window and check, with this model's weights and
plain reference (``reference/dinov2.py``), batches uploaded from pinned host
memory where the configuration pins its loader's, and its counters: its
operation count (``flops_dinov2.py``), K2's bounds at its 24 heads and 1374
tokens, the bf16 linears a step left on the f32 products, and the least time
of the step's linear products on the tensor cores.

The model is built on the meta device before the kernel libraries load, so
a program without this arch refuses the cell within seconds.
"""
from __future__ import annotations

import torch

from sodbench import flops, flops_dinov2
from sodbench.drivers import train
from sodbench.drivers.common import WEIGHT_STREAM, free, load_libraries, program_config
from sodbench.inputs import generator
from sodbench.reference import dinov2
from sodbench.reference.model import Arith, make_weights, tf32_off


def weights(ctx, device):
    """Every tensor of the model from the seed, f32, on ``device``."""
    return make_weights(dinov2.param_specs(), generator(ctx.seed, WEIGHT_STREAM, device),
                        device)


class Driver(train.Driver):
    def setup(self, clock) -> None:
        with clock.phase("imports"):
            from sod_tpu_torch.models.maskformer import MaskFormer, config_from
            from sod_tpu_torch.ops import layers
            from sod_tpu_torch.train.optim import build_optimizer
            from sod_tpu_torch.train.step import make_train_step
            cfg = program_config(self.ctx)
            with torch.device("meta"):
                model = MaskFormer(config_from(cfg))
            self.layers = layers
        with clock.phase("ext_load"):
            load_libraries(self.ctx.config.get("libraries", []), self.dev)
        with clock.phase("weights"):
            model = model.to_empty(device=self.dev)
            model.load_state_dict(weights(self.ctx, self.dev))
            opt = build_optimizer(cfg, model.parameters(),
                                  n_iters_per_epoch=self.total_iters // cfg.n_epochs)
            self.model, self.opt = model, opt
            self.step = make_train_step(cfg, model, opt)
        with clock.phase("inputs"):
            pin = self.dev.type == "cuda" and bool(self.ctx.config["config"].get("pin_memory"))
            self.pool = [{k: v.cpu().pin_memory() if pin else v.cpu()
                          for k, v in self.device_batch(i).items()}
                         for i in range(self.t["pool_batches"])]
        with clock.phase("warmup"):
            self.prog = self._checked_steps()
        self.next = self.checked

    def _upload(self, i: int) -> dict:
        """A pooled batch to the card.  Under the configuration's
        ``pin_memory`` (the loader's pinned batches) the copy is queued
        behind the steps already enqueued; from pageable memory the host
        would wait for them to finish before it could go on."""
        host = self.pool[i % len(self.pool)]
        return {k: v.to(self.dev, non_blocking=True) for k, v in host.items()}

    def run_window(self, seconds: float) -> dict:
        before = self.layers.tc_linears, self.layers.f32_linears
        window = super().run_window(seconds)
        steps = len(self.losses)
        self.linears = {"tc": (self.layers.tc_linears - before[0]) / steps,
                        "f32": (self.layers.f32_linears - before[1]) / steps}
        return window

    def counters(self) -> dict:
        steps = len(self.losses)
        hw = (self.size, self.size)
        n = flops_dinov2.tokens(hw)
        heads, hd = flops_dinov2.HEADS, flops_dinov2.D // flops_dinov2.HEADS
        return {"kind": "train", "steps": steps, "images": steps * self.batch,
                "window_s": (self.window["t1_ns"] - self.window["t0_ns"]) / 1e9,
                "flops": steps * self.batch * flops_dinov2.train_flops(hw),
                "k2_fwd_bound_s": flops.bound_s(*flops.k2_forward(self.batch, heads, n, hd)),
                "k2_bwd_bound_s": flops.bound_s(*flops.k2_backward(self.batch, heads, n, hd)),
                "tc_linears_per_step": self.linears["tc"],
                "f32_linears_per_step": self.linears["f32"],
                "gemm_bound_s_per_step": flops_dinov2.linear_bound_s(self.batch, hw)}

    def reference(self, prec: str = "f32", keep_rows: float = 1.0) -> dict:
        """The reference's readings, as ``train.Driver.reference``'s."""
        with tf32_off():
            w = weights(self.ctx, self.dev)
            batches = [self.device_batch(i) for i in range(self.checked)]
            ref = dinov2.train_steps(w, batches, self.ctx.config["config"], self.total_iters,
                                     Arith(prec), keep_rows)
            out = {"losses": ref["losses"],
                   "grad": {k: float(g.norm()) for k, g in ref["first_grad"].items()},
                   "change": {k: float((p - w[k]).norm()) for k, p in ref["params"].items()}}
        del w, batches, ref
        free(self.dev)
        return out
