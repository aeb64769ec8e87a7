"""Poly LR schedule with linear warmup (twin of
``sod_tpu/train/lr_schedule.py``), evaluated on the host in f32 as
``sod_tpu``'s jnp schedule is.

``cycle_iters`` reproduces the reference's per-epoch counter wrap
(``utils/lr_scheduler.py:38``): T runs 0, 1..n, 1..n, ... and revisits 0
only at the very first step.  Leave it ``None`` for the monotone decay.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def poly_schedule(base_lr: float, total_iters: int, warmup_iters: int = 0,
                  power: float = 0.9,
                  cycle_iters: Optional[int] = None) -> Callable[[int], np.float32]:
    def schedule(step: int) -> np.float32:
        t = np.float32(step)
        if cycle_iters and t > cycle_iters:
            t = np.mod(t - np.float32(1), np.float32(cycle_iters)) + np.float32(1)
        if warmup_iters > 0 and t < warmup_iters:
            factor = t / np.float32(max(warmup_iters, 1))
        else:
            factor = np.maximum(np.float32(1) - t / np.float32(total_iters),
                                np.float32(0)) ** np.float32(power)
        return np.float32(np.float32(base_lr) * factor)

    return schedule
