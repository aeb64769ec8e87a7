"""The service under a closed loop: ``callers`` threads each call
``SelfMaskInference.model_step`` with a uint8 image of the model's size,
drawn from a pool of seeded distinct images, and call again as soon as the
reply comes, as the pool's HTTP workers do through ``InferenceBroker`` in
the process that owns the card.  Micro-batching is set by the traffic's
overrides, never probed.

The callers start during set-up and run through ``warm_s`` seconds before
the window opens, so the window sees the service in its steady state.  A
request counts in the window when its reply reaches its caller inside it;
its latency is the caller's whole wait.  The harness wraps the service's
``forward_u8`` to count the forwards and their rows.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from sodbench import flops, inputs
from sodbench.drivers.common import free, load_libraries, program_config, sync, weights
from sodbench.reference.model import Arith, forward, tf32_off

IMAGE_STREAM = 200
SAMPLE_STREAM = 201
REF_ROWS = 32


def u8_mask(mask: np.ndarray) -> np.ndarray:
    """The service's quantisation of a mask in [0, 1]."""
    return (np.clip(mask, 0.0, 1.0) * 255).astype(np.uint8)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        self.t = ctx.traffic
        self.size = ctx.config["config"]["eval_image_size"]
        self.arch = ctx.config["config"]["arch"]

    def device_images(self) -> torch.Tensor:
        g = inputs.generator(self.ctx.seed, IMAGE_STREAM, self.dev)
        return inputs.images(g, self.t["image_pool"], self.size, self.size, self.dev)

    # -- set-up ---------------------------------------------------------
    def setup(self, clock) -> None:
        with clock.phase("imports"):
            from sod_tpu_torch.serving.inference import SelfMaskInference
            cfg = program_config(self.ctx)
        with clock.phase("ext_load"):
            load_libraries(self.ctx.config.get("libraries", []), self.dev)
        with clock.phase("weights"):
            w = weights(self.ctx, self.dev)
        with clock.phase("inputs"):
            self.pool = list(self.device_images().cpu().numpy())
        with clock.phase("warmup"):
            self.svc = SelfMaskInference(cfg=cfg, device=self.dev, state_dict=w, warmup=True)
            del w
            self._count_forwards()
            self._start_callers()
            time.sleep(self.t["warm_s"])

    def _count_forwards(self) -> None:
        inner, spans = self.svc.forward_u8, self.ctx.spans
        self.forwards: List[tuple] = []

        def forward_u8(batch):
            t = time.perf_counter_ns()
            with spans.span("forward"):
                out = inner(batch)
            self.forwards.append((t, batch.shape[0]))
            return out

        self.svc.forward_u8 = forward_u8

    def _start_callers(self) -> None:
        n, k = self.t["callers"], len(self.pool)
        self.stop = threading.Event()
        self.records: List[List[tuple]] = [[] for _ in range(n)]
        self.errors: List[tuple] = []

        def caller(c: int) -> None:
            j = 0
            while not self.stop.is_set():
                idx = (c + j * n) % k
                t0 = time.perf_counter_ns()
                try:
                    mask, obj = self.svc.model_step(self.pool[idx])
                except Exception as e:  # noqa: BLE001 - a failed request is counted
                    self.errors.append((time.perf_counter_ns(), repr(e)))
                    continue
                self.records[c].append((t0, time.perf_counter_ns(), idx, mask, obj))
                j += 1

        self.threads = [threading.Thread(target=caller, args=(c,), daemon=True)
                        for c in range(n)]
        for th in self.threads:
            th.start()

    # -- the window -----------------------------------------------------
    def run_window(self, seconds: float) -> dict:
        t0 = time.perf_counter_ns()
        time.sleep(seconds)
        t1 = time.perf_counter_ns()
        self.stop.set()
        for th in self.threads:
            th.join(timeout=120.0)
        if any(th.is_alive() for th in self.threads):
            raise RuntimeError("a caller did not return within 120 s of the window's end")
        sync(self.dev)
        self.window = {"t0_ns": t0, "t1_ns": t1}
        self.done = [r for recs in self.records for r in recs if t0 <= r[1] <= t1]
        return self.window

    def counters(self) -> dict:
        t0, t1 = self.window["t0_ns"], self.window["t1_ns"]
        rows = [b for t, b in self.forwards if t0 <= t <= t1]
        n_tok = (self.size // self.ctx.config["config"]["patch_size"]) ** 2 + 1
        k1 = {b: 12 * flops.bound_s(*flops.k1_block(b, n_tok)) for b in set(rows)}
        return {"kind": "serve", "requests": len(self.done), "forwards": len(rows),
                "window_s": (t1 - t0) / 1e9,
                "latencies_s": [(r[1] - r[0]) / 1e9 for r in self.done],
                "flops": len(self.done) * flops.forward_flops(self.arch, (self.size, self.size)),
                "k1_bound_s": sum(k1[b] for b in rows)}

    def attempted_failed(self):
        t0, t1 = self.window["t0_ns"], self.window["t1_ns"]
        failed = sum(1 for t, _ in self.errors if t0 <= t <= t1)
        return len(self.done) + failed, failed

    def release(self) -> None:
        self.svc.close()
        del self.svc
        free(self.dev)

    # -- the check ------------------------------------------------------
    def sample(self) -> List[tuple]:
        """The requests the check compares: drawn from the seed among those
        completed in the window."""
        rng = np.random.default_rng(inputs.seed_value(self.ctx.seed, SAMPLE_STREAM))
        n = min(self.t["sample"], len(self.done))
        return [self.done[i] for i in sorted(rng.choice(len(self.done), n, replace=False))]

    def reference(self, idx: List[int], prec: str = "f32") -> Dict[str, np.ndarray]:
        """The reference's last-layer objectness [n, Q] and masks [n, Q, h, w]
        for pool images ``idx``, in blocks of ``REF_ROWS`` rows."""
        objs, masks = [], []
        with tf32_off(), torch.inference_mode():
            w = weights(self.ctx, self.dev)
            pool = self.device_images()
            for i in range(0, len(idx), REF_ROWS):
                sel = torch.as_tensor(idx[i:i + REF_ROWS], device=self.dev)
                out = forward(w, pool[sel], self.arch, Arith(prec))
                objs.append(out["objectness"][:, -1].cpu().numpy())
                masks.append(out["mask_pred"][:, -1].cpu().numpy())
            del w, pool
        free(self.dev)
        return {"obj": np.concatenate(objs), "masks": np.concatenate(masks)}

    @staticmethod
    def as_answers(ref: Dict[str, np.ndarray]) -> List[tuple]:
        """What the service would answer from these outputs: the mask of the
        query of highest objectness, quantised, and the objectness."""
        best = ref["obj"].argmax(1)
        return [(u8_mask(m[b]), o) for m, o, b in zip(ref["masks"], ref["obj"], best)]

    @staticmethod
    def compare(answers: List[tuple], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
        """obj_gap: the widest objectness gap; pick_gap: how far below the
        reference's best objectness the answered mask's query lies; mask_gap:
        the widest gap, in 1/255, between the answered mask and the
        reference's mask of the same query."""
        obj_gap = pick_gap = mask_gap = 0.0
        for (mask, obj), r_obj, r_masks in zip(answers, ref["obj"], ref["masks"]):
            q = int(np.argmax(obj))
            obj_gap = max(obj_gap, float(np.abs(obj - r_obj).max()))
            pick_gap = max(pick_gap, float(r_obj.max() - r_obj[q]))
            diff = np.abs(mask.astype(np.int16) - u8_mask(r_masks[q]).astype(np.int16))
            mask_gap = max(mask_gap, float(diff.max()) / 255.0)
        return {"obj_gap": obj_gap, "pick_gap": pick_gap, "mask_gap": mask_gap}

    def readings(self) -> Dict[str, float]:
        sample = self.sample()
        ref = self.reference([r[2] for r in sample])
        return self.compare([(r[3], r[4]) for r in sample], ref)

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        """The compared numbers of the program, of the control (the
        reference in fp8 in the program's place) and of answers handed to
        the wrong callers (each sampled answer moved to the next request)."""
        sample = self.sample()
        idx = [r[2] for r in sample]
        ref = self.reference(idx)
        answers = [(r[3], r[4]) for r in sample]
        return {"program": self.compare(answers, ref),
                "control": self.compare(self.as_answers(self.reference(idx, "fp8")), ref),
                "swapped": self.compare(answers[1:] + answers[:1], ref)}
