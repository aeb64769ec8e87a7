"""Cells at a size the CPU runs in seconds: the real widths and depths,
small images and batches."""
import copy
import time
from types import SimpleNamespace

import torch


def tiny_ctx(config: str, traffic: str, seed: int = 2 ** 33 + 7, config_updates=None,
             traffic_updates=None, device="cpu"):
    """A cell's context at a size the CPU runs in seconds: the real widths
    and depths, small images and batches."""
    from sodbench import harness
    from sodbench.trace import Spans

    man = harness.manifest()
    cfg = copy.deepcopy(harness.config_file(man, config))
    cfg["config"].update(config_updates or {})
    tr = harness.traffic_file(traffic)
    tr.update(traffic_updates or {})
    return SimpleNamespace(seed=seed, device=torch.device(device), cell={}, workload=traffic,
                           config=cfg, traffic=tr, spans=Spans(False))


# (config updates, traffic updates, window seconds) of each traffic mix
TINY = {
    "train_steps": ({"batch_size": 4, "train_image_size": 32}, {"pool_batches": 4}, 0.3),
    "serve_closed": ({"eval_image_size": 32},
                     {"callers": 8, "image_pool": 16, "warm_s": 0.5, "sample": 16}, 3.0),
    "eval_canvas": ({"num_workers": 2}, {"images": 8, "sides": [24, 40], "batch": 4}, 0.3),
}


def run_tiny(config: str, traffic: str, **kw):
    """Set-up, window and release of a cell at its tiny size; returns the
    driver, ready for ``readings`` or ``calibrate``."""
    from sodbench import harness

    cu, tu, seconds = TINY[traffic]
    ctx = tiny_ctx(config, traffic, config_updates=cu, traffic_updates=tu, **kw)
    driver = harness.driver_module(ctx.traffic).Driver(ctx)
    driver.setup(harness.SetupClock(time.perf_counter()))
    driver.run_window(seconds)
    driver.counters()
    driver.attempted_failed()
    driver.release()
    return driver
