"""Export a model checkpoint of the port to the reference's torch layout
(twin of ``sod_tpu/cli/export.py``).

``python -m sod_tpu_torch.cli.export --ckpt ckpt/<experiment>/best_model_duts.pt \\
    --out selfmask_export.pt``

Writes ``{'model': state_dict}`` exactly as the reference's consumers
load it (``app.py:185-187`` pops ``['model']``; ``evaluator.py
--p_state_dict``): the port's modules already use the ``selfmask_nq20.pt``
key names, shapes and (out, in) linear layout, so the export re-wraps the
weights in f32.

``--ckpt`` accepts a checkpoint file of the port's Trainer (``latest_model.pt``
/ ``best_model_*.pt``; its epoch and iteration count are kept beside the
model as ``n_epochs`` and ``n_iters``, as ``sod_tpu`` keeps an orbax
checkpoint's) or a torch ``.pt`` (re-wrapped, useful to normalize a
``{'model': ...}``-less state dict).  An orbax checkpoint directory is
refused, as everywhere in the port (ROADMAP item 13).
"""
from __future__ import annotations

import argparse
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch export")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint of the port's Trainer "
                        "(latest_model.pt/best_model_*.pt) or a torch .pt "
                        "to re-wrap")
    p.add_argument("--out", required=True, help="output .pt path")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    from sod_tpu_torch.models.convert import (
        require_torch_checkpoint,
        save_torch_checkpoint,
        state_dict_of,
    )
    from sod_tpu_torch.train.checkpoints import restore_checkpoint

    require_torch_checkpoint(args.ckpt)
    payload = restore_checkpoint(args.ckpt)
    extra = {}
    if isinstance(payload, dict) and "epoch" in payload:       # the Trainer's
        extra = {"n_epochs": int(payload["epoch"]),
                 "n_iters": int(payload.get("n_iters", 0))}
    save_torch_checkpoint(args.out, state_dict_of(payload), extra=extra)
    n = os.path.getsize(args.out)
    print(f"wrote {args.out} ({n / 1e6:.1f} MB, reference 'model' layout)")


if __name__ == "__main__":
    main()
