"""Canvas evaluation: repeated calls of the program's ``Evaluator`` on a
synthetic DUTS-TE that set-up writes into ``TMPDIR`` (JPEG images of a
bright box on a dark noisy ground and PNG masks, sides drawn from the seed
within the traffic's range, the first image at the largest side so the
canvas is that size).  Each call decodes, collates every batch into the
canvas, runs the canvas forward, the metrics and the final fetch; set-up
makes the first call, which warms every shape.  The window runs whole
calls; it ends with the first call that ends after ``seconds``.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from glob import glob
from typing import Dict, List

import numpy as np
import torch

from sodbench import flops, inputs
from sodbench.drivers.common import free, load_libraries, program_config, sync, weights
from sodbench.reference.evaluate import canvas_masks, query_scores
from sodbench.reference.model import Arith, tf32_off

DATA_STREAM = 300


def write_duts_te(root: str, n: int, lo: int, hi: int, seed: int) -> None:
    """A synthetic DUTS-TE split under ``root/DUTS``: JPEG images (a bright
    box on a dark noisy ground) and PNG masks with sides in [lo, hi]; the
    first image is hi x hi, so the canvas is hi px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    te, gtd = (os.path.join(root, "DUTS", d) for d in ("DUTS-TE-Image", "DUTS-TE-Mask"))
    os.makedirs(te)
    os.makedirs(gtd)
    for i in range(n):
        h, w = (hi, hi) if i == 0 else rng.integers(lo, hi + 1, 2)
        img = (rng.random((h, w, 3)) * 60).astype(np.uint8)
        y0, x0 = rng.integers(0, h // 3), rng.integers(0, w // 3)
        y1, x1 = y0 + rng.integers(h // 4, h // 2), x0 + rng.integers(w // 4, w // 2)
        img[y0:y1, x0:x1] += 150
        gt = np.zeros((h, w), np.uint8)
        gt[y0:y1, x0:x1] = 255
        Image.fromarray(img).save(os.path.join(te, f"te_{i:03d}.jpg"), quality=95)
        Image.fromarray(gt).save(os.path.join(gtd, f"te_{i:03d}.png"))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        self.t = ctx.traffic
        self.patch = ctx.config["config"]["patch_size"]

    def setup(self, clock) -> None:
        with clock.phase("imports"):
            from sod_tpu_torch.models.maskformer import MaskFormer, config_from
            from sod_tpu_torch.train.evaluator import Evaluator
            cfg = program_config(self.ctx)
        with clock.phase("ext_load"):
            load_libraries(self.ctx.config.get("libraries", []), self.dev)
        with clock.phase("weights"):
            self.model = MaskFormer(config_from(cfg)).to_empty(device=self.dev)
            self.model.load_state_dict(weights(self.ctx, self.dev))
        with clock.phase("inputs"):
            self.root = tempfile.mkdtemp(prefix="sodbench-duts-")
            lo, hi = self.t["sides"]
            write_duts_te(self.root, self.t["images"], lo, hi,
                          inputs.seed_value(self.ctx.seed, DATA_STREAM))
        with clock.phase("warmup"):
            self.evaluator = Evaluator(self.model, cfg, dir_dataset=self.root,
                                       batch_size=self.t["batch"], device=self.dev)
            self.csv_dirs: List[str] = []
            self._call()
            self.csv_dirs.clear()

    def _call(self) -> Dict[str, float]:
        """One Evaluator call, writing its per-image rows into a directory of
        its own, as the Trainer and the evaluate CLI give it one."""
        d = os.path.join(self.root, "eval", str(len(self.csv_dirs)))
        self.csv_dirs.append(d)
        with self.ctx.spans.span("evaluator_call"):
            return self.evaluator(self.t["dataset"], dir_ckpt=d, cost_type=self.t["cost_type"])

    def run_window(self, seconds: float) -> dict:
        sync(self.dev)
        t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        self.results: List[Dict[str, float]] = []
        while True:
            self.results.append(self._call())
            if time.perf_counter_ns() >= deadline:
                break
        sync(self.dev)
        t1 = time.perf_counter_ns()
        self.window = {"t0_ns": t0, "t1_ns": t1}
        return self.window

    def _sizes(self) -> List[tuple]:
        from PIL import Image

        out = []
        for fp in sorted(glob(os.path.join(self.root, "DUTS", "DUTS-TE-Image", "*.jpg"))):
            with Image.open(fp) as im:
                out.append((im.size[1], im.size[0]))
        return out

    def counters(self) -> dict:
        calls = len(self.results)
        sizes = self._sizes()
        tokens = [math.ceil(h / self.patch) * math.ceil(w / self.patch) + 1 for h, w in sizes]
        b = self.t["batch"]
        batches = [tokens[i:i + b] for i in range(0, len(tokens), b)]
        k2_call = 12 * sum(flops.bound_s(*flops.k2_forward_masked(t, 6, 64)) for t in batches)
        return {"kind": "eval", "calls": calls, "images": calls * len(sizes),
                "window_s": (self.window["t1_ns"] - self.window["t0_ns"]) / 1e9,
                "flops": calls * flops.canvas_flops(tokens, self.patch),
                "k2_fwd_bound_s": k2_call / (12 * len(batches))}

    def attempted_failed(self):
        bad = sum(1 for r in self.results if not all(math.isfinite(r[k]) for k in r))
        return len(self.results), bad

    def release(self) -> None:
        for name in ("evaluator", "model"):
            self.__dict__.pop(name, None)
        free(self.dev)

    # -- the check ------------------------------------------------------
    def reference(self, prec: str = "f32") -> List[dict]:
        """Per image, in the dataset's order: every query's seven metrics,
        objectness and IoU (``reference.evaluate.query_scores``)."""
        from PIL import Image

        imgs = sorted(glob(os.path.join(self.root, "DUTS", "DUTS-TE-Image", "*.jpg")))
        gts = sorted(glob(os.path.join(self.root, "DUTS", "DUTS-TE-Mask", "*.png")))
        grid = max(math.ceil(max(h, w) / self.patch) for h, w in self._sizes())
        out = []
        with tf32_off(), torch.inference_mode():
            w = weights(self.ctx, self.dev)
            for fi, fg in zip(imgs, gts):
                img = torch.from_numpy(np.array(Image.open(fi).convert("RGB"), np.uint8))
                gt = torch.from_numpy(np.array(Image.open(fg).convert("L")) > 0)
                m = canvas_masks(w, img.to(self.dev), grid, Arith(prec), self.patch)
                out.append(query_scores(m["masks"], m["objectness"], gt.to(self.dev)))
            del w
        free(self.dev)
        return out

    @staticmethod
    def answers(ref: List[dict]) -> List[List[float]]:
        """The rows an evaluator computing as ``ref`` would write: the metrics
        of the query of highest objectness, then of the query of best IoU."""
        rows = []
        for r in ref:
            sel = int(np.argmax(r["objectness"]))
            ub = int(np.argmax(r["iou"]))
            rows.append(list(r["metrics"][sel]) + list(r["metrics"][ub]))
        return rows

    @staticmethod
    def compare(calls: List[List[List[float]]], ref: List[dict]) -> Dict[str, float]:
        """Each image's row (seven metrics of the selected mask, seven of the
        upper bound) against the reference's query whose metrics it matches
        best.  metric_gap: the widest gap of a metric to that query's;
        pick_gap: how far the matched selected query's objectness lies below
        the reference's best; ub_gap: how far the matched upper-bound query's
        IoU lies below the reference's best."""
        metric_gap = pick_gap = ub_gap = 0.0
        for rows in calls:
            for row, r in zip(rows, ref):
                m = np.asarray(r["metrics"])
                for part, score in ((row[:7], r["objectness"]), (row[7:], r["iou"])):
                    d = np.abs(m - np.asarray(part)[None]).max(1)
                    q = int(np.argmin(d))
                    metric_gap = max(metric_gap, float(d[q]))
                    below = float(max(score) - score[q])
                    if score is r["objectness"]:
                        pick_gap = max(pick_gap, below)
                    else:
                        ub_gap = max(ub_gap, below)
        return {"metric_gap": metric_gap, "pick_gap": pick_gap, "ub_gap": ub_gap}

    def program_rows(self) -> List[List[List[float]]]:
        """The per-image rows of every call of the window, from the CSV each
        call wrote."""
        out = []
        for d in self.csv_dirs:
            with open(os.path.join(d, f"metrics_{self.t['dataset']}.txt")) as f:
                out.append([[float(v) for v in line.split(",")] for line in f.read().splitlines()[1:]])
        return out

    def readings(self) -> Dict[str, float]:
        try:
            return self.compare(self.program_rows(), self.reference())
        finally:
            shutil.rmtree(self.root, ignore_errors=True)

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        """The program's numbers, the control's (the reference in fp8 in the
        program's place) and a fault's (the query of lowest objectness
        answered in place of the highest)."""
        try:
            ref = self.reference()
            worst = [list(r["metrics"][int(np.argmin(r["objectness"]))])
                     + list(r["metrics"][int(np.argmax(r["iou"]))]) for r in ref]
            return {"program": self.compare(self.program_rows(), ref),
                    "control": self.compare([self.answers(self.reference("fp8"))], ref),
                    "wrong_pick": self.compare([worst], ref)}
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
