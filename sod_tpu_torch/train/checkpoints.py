"""Checkpoints of the port (twin of ``sod_tpu/train/checkpoints.py``).

One file per checkpoint, written with ``torch.save`` to a temporary name
and renamed into place, so a kill mid-write leaves the previous checkpoint
intact.  Contents: ``model`` (the reference's state-dict layout, so
``models.convert.load_torch_state_dict`` and the service load it as it is),
``optimizer`` (``ClippedAdamW.state_dict``), ``epoch``, ``n_iters`` and
``extra``.  Loaded with ``weights_only=True``: tensors and plain
containers only.

``AsyncSaver`` overlaps the write with training.  ``sod_tpu``'s passes its
immutable jax arrays by reference; here the optimizer updates parameters
and moments in place, so ``save`` first copies them to the host on the
caller's thread, and only ``torch.save`` and the rename run on the writer
thread.

Under a data mesh the Trainer gathers the whole state on every rank
(``StateLayout.full_state``) and rank 0 writes it: the file is the same
under every layout, and any layout resumes it.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Mapping, Optional

import torch


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that later in-place updates of ``t`` cannot reach."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.cpu()


def snapshot(model, optimizer=None, epoch: int = 0,
             n_iters: int = 0, extra: Optional[Dict] = None) -> Dict:
    """The checkpoint's contents, copied to the host.  ``model`` and
    ``optimizer`` are the objects or their state dicts (a data-parallel
    Trainer hands the whole state that ``StateLayout.full_state`` gathered)."""
    model_state = model if isinstance(model, Mapping) else model.state_dict()
    payload = {"model": {k: _host_copy(v) for k, v in model_state.items()},
               "epoch": epoch, "n_iters": n_iters}
    if optimizer is not None:
        opt_state = optimizer if isinstance(optimizer, Mapping) else optimizer.state_dict()
        payload["optimizer"] = {
            k: ([_host_copy(t) for t in v] if isinstance(v, list) else v)
            for k, v in opt_state.items()}
    if extra:
        payload["extra"] = extra
    return payload


def write_checkpoint(path: str, payload: Dict) -> None:
    """``torch.save`` to a temporary name, then an atomic rename."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, model, optimizer=None,
                    epoch: int = 0, n_iters: int = 0,
                    extra: Optional[Dict] = None) -> None:
    """Write a training checkpoint to the file ``path``."""
    write_checkpoint(path, snapshot(model, optimizer, epoch, n_iters, extra))


class AsyncSaver:
    """Overlapped checkpoint writes (``Config.async_checkpoint``).

    ``save`` returns once the state is copied to the host (the device to
    host copies wait for the card's queue, so they see the last update);
    the write runs on a non-daemon thread, so a normal interpreter exit
    waits for it.  One save in flight at a time: a new ``save`` waits for
    the previous one first.  A kill mid-write leaves the previous
    checkpoint, as the synchronous path does."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, model, optimizer=None,
             **kw) -> None:
        self.wait()
        payload = snapshot(model, optimizer, **kw)

        def write():
            try:
                write_checkpoint(path, payload)
            except Exception as e:  # noqa: BLE001
                self._error = e          # re-raised by wait()

        self._thread = threading.Thread(target=write, daemon=False,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) is on disk; re-raise its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def restore_checkpoint(path: str, map_location="cpu") -> Dict:
    """Load a checkpoint written by ``save_checkpoint``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
