"""Training entry point of the port (twin of ``sod_tpu/cli/train.py``):

    python -m sod_tpu_torch.cli.train --config configs/<yaml> \\
        [--seed N] [--suffix S] [--resume] [--p_state_dict ckpt.pt] [--device cuda]
        [--gpu_id 0] [--async-checkpoint]

yaml -> Config, seeds, ``Trainer`` on one device, epochs each followed by
the canvas evaluation of the benchmarks on disk, ``--resume`` from this
experiment's ``latest_model.pt``; ``--async-checkpoint`` overlaps that
write with the next epoch and waits for it at the end.
The mesh flags of ``sod_tpu``'s CLI are accepted and refused: the parallel
layouts are ROADMAP item 12.
"""
from __future__ import annotations

import argparse

from sod_tpu_torch.config import define_experim_name, load_config
from sod_tpu_torch.utils.misc import set_seeds

# argparse dest -> flag, for sod_tpu's mesh flags
_MESH_FLAGS = {"n_devices": "--n_devices", "tp": "--tp", "pp": "--pp",
               "sp": "--sp", "fsdp": "--fsdp"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch train")
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--debug", "-d", action="store_true")
    p.add_argument("--gpu_id", type=int, default=0,
                   help="kept for reference-CLI parity and unused; --device "
                        "names the device")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--suffix", type=str, default=None)
    p.add_argument("--p_state_dict", type=str, default=None,
                   help="torch checkpoint in the reference layout to "
                        "initialise from")
    p.add_argument("--resume", action="store_true",
                   help="resume from this experiment's latest_model.pt")
    p.add_argument("--device", type=str, default="cuda",
                   help="the one device to train on")
    # sod_tpu's mesh flags: refused (ROADMAP item 12)
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--pp", type=int, default=None)
    p.add_argument("--sp", type=int, default=None)
    p.add_argument("--fsdp", type=str, default=None, choices=["zero1", "full"])
    p.add_argument("--async-checkpoint", action="store_true",
                   help="overlap the per-epoch latest_model.pt write with "
                        "the next epoch")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    for dest, flag in _MESH_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            raise NotImplementedError(
                f"{flag} is not ported to sod_tpu_torch: the port trains on one "
                "device (ROADMAP item 12, the parallel layouts)")
    overrides = {"debug": args.debug}
    if args.async_checkpoint:
        overrides["async_checkpoint"] = True
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.suffix is not None:
        overrides["suffix"] = args.suffix
    cfg = load_config(args.config, overrides)
    set_seeds(cfg.seed)

    from sod_tpu_torch.models.convert import load_torch_state_dict
    from sod_tpu_torch.train.trainer import Trainer

    state_dict = None
    if args.p_state_dict:
        state_dict = load_torch_state_dict(args.p_state_dict)
        print(f"Pre-trained weights are loaded from {args.p_state_dict}")
    trainer = Trainer(cfg, device=args.device, state_dict=state_dict,
                      debug=cfg.debug)
    print(f"experiment: {define_experim_name(cfg)} -> {trainer.dir_ckpt}")
    start_epoch = 1
    if args.resume:
        start_epoch = trainer.resume()
        print(f"resumed; continuing from epoch {start_epoch}")
    trainer(cfg.n_epochs, start_epoch=start_epoch)
    trainer.wait_for_checkpoints()


if __name__ == "__main__":
    main()
