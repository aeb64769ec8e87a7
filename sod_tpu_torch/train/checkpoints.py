"""Checkpoints of the port (twin of ``sod_tpu/train/checkpoints.py``).

One file per checkpoint, written with ``torch.save`` to a temporary name
and renamed into place, so a kill mid-write leaves the previous checkpoint
intact.  Contents: ``model`` (the reference's state-dict layout, so
``models.convert.load_torch_state_dict`` and the service load it as it is),
``optimizer`` (``ClippedAdamW.state_dict``), ``epoch``, ``n_iters`` and
``extra``.  Loaded with ``weights_only=True``: tensors and plain
containers only.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    epoch: int = 0, n_iters: int = 0,
                    extra: Optional[Dict] = None) -> None:
    """Write a training checkpoint to the file ``path``."""
    payload = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
               "epoch": epoch, "n_iters": n_iters}
    if optimizer is not None:
        payload["optimizer"] = {
            k: ([t.cpu() for t in v] if isinstance(v, list) else v)
            for k, v in optimizer.state_dict().items()}
    if extra:
        payload["extra"] = extra
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location="cpu") -> Dict:
    """Load a checkpoint written by ``save_checkpoint``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
