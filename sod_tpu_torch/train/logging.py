"""Training observability of the port (twin of ``sod_tpu/train/logging.py``):
an append-only ``metrics.jsonl`` in the checkpoint directory, plus wandb
when importable and ``SOD_WANDB=1``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, dir_ckpt: str, project: str = "SelfMask",
                 name: Optional[str] = None):
        os.makedirs(dir_ckpt, exist_ok=True)
        self.fp = os.path.join(dir_ckpt, "metrics.jsonl")
        self._wandb = None
        if os.environ.get("SOD_WANDB") == "1":
            try:
                import wandb

                wandb.init(project=project, name=name)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.fp, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics)
