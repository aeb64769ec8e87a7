"""Time the train step with span recording on and off.

    python3 -m sod_tpu_torch.tools.span_cost [--batch 64] [--steps 20] [--runs 5]

The shipped config's step (ViT-S/8 through K2, bf16 compute, f32
parameters, 224 px) at ``--batch`` images, seeded weights and one batch
kept on the card.  After three warm-up steps each run times ``--steps``
steps between two synchronizes on the host clock, ``--runs`` runs each
way in turns (off, on, on, off, ...) with no profiler running; "on" is
inside ``profiling.recording()`` (a span then records two CUDA events).
Also times ``with span(...)`` alone, off and on, in host ns a span.
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time


def span_ns(on: bool, n: int) -> float:
    """Host ns of one empty ``with span("x")``, less the bare loop's."""
    from sod_tpu_torch.utils import profiling

    def loop(body: bool) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            if body:
                with profiling.span("x"):
                    pass
        return (time.perf_counter_ns() - t) / n

    if not on:
        return loop(True) - loop(False)
    with profiling.recording():
        got = loop(True) - loop(False)
    profiling.reset()
    return got


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step
    from sod_tpu_torch.utils import profiling

    cfg = dataclasses.replace(load_config(cs.CONFIG), batch_size=args.batch)
    model = MaskFormer(config_from(cfg))
    model.load_state_dict(random_state_dict(model, cfg.seed))
    model.to(args.device)
    sync = torch.cuda.synchronize if args.device.startswith("cuda") else (lambda: None)
    opt = build_optimizer(cfg, model.parameters(), n_iters_per_epoch=1000)
    step = make_train_step(cfg, model, opt)
    batch = {k: torch.from_numpy(v).to(args.device) for k, v in cs.synthetic_batch(
        np.random.default_rng(7), args.batch, cfg.train_image_size, cfg.max_gt_masks).items()}
    for _ in range(3):
        step(batch)
    sync()

    def run(on: bool) -> float:
        with profiling.recording() if on else contextlib.nullcontext():
            sync()
            t = time.perf_counter()
            for _ in range(args.steps):
                step(batch)
            sync()
            ms = (time.perf_counter() - t) * 1e3 / args.steps
        if on:
            spans = len(profiling.records())
            profiling.reset()
            if spans != 5 * args.steps:
                raise AssertionError(f"{spans} spans for {args.steps} steps")
        return ms

    runs = {"off": [], "on": []}
    for r in range(args.runs):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            runs["on" if on else "off"].append(run(on))
    med = {k: statistics.median(v) for k, v in runs.items()}
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        card = args.device
    print(json.dumps({"card": card, "batch": args.batch, "steps": args.steps,
                      "ms_per_step": runs, "median_off": med["off"], "median_on": med["on"],
                      "on_minus_off_ms": med["on"] - med["off"],
                      "span_host_ns_off": span_ns(False, 200_000),
                      "span_host_ns_on": span_ns(True, 20_000)}))


if __name__ == "__main__":
    main()
