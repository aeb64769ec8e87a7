"""Training entry point of the port (twin of ``sod_tpu/cli/train.py``):

    python -m sod_tpu_torch.cli.train --config configs/<yaml> \\
        [--seed N] [--suffix S] [--resume] [--p_state_dict ckpt.pt] [--device cuda]
        [--gpu_id 0] [--async-checkpoint] [--n_devices N] [--fsdp zero1|full]
        [--tp T] [--pp P] [--sp S]

yaml -> Config, seeds, ``Trainer``, epochs each followed by the canvas
evaluation of the benchmarks on disk, ``--resume`` from this experiment's
``latest_model.pt``; ``--async-checkpoint`` overlaps that write with the
next epoch and waits for it at the end.

``--n_devices N`` (default: every card, as ``sod_tpu`` takes every device;
one under ``--device cpu``) above 1 trains data-parallel: N rank processes
are spawned, rank r on ``cuda:r`` over NCCL (or on the CPU over gloo), each
with its rows of every batch; ``--fsdp zero1|full`` shards the optimizer
moments, or the weights too, over them.  ``--tp``, ``--pp`` and ``--sp``
(or the config's ``mesh_{model,pipe,seq}_axis``) add the model-sharding
layouts (``parallel/``; the plain PyTorch path): N x tp x pp x sp ranks are
spawned (N then defaults to the cards left after the other axes), ``--tp``
with ``--pp`` runs p3 and ``--tp`` with ``--sp`` sptp, as in ``sod_tpu``;
more ranks than cards raise ``sod_tpu``'s ``ValueError`` before any
rendezvous.
"""
from __future__ import annotations

import argparse
import sys

from sod_tpu_torch.config import define_experim_name, load_config
from sod_tpu_torch.utils.misc import set_seeds


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
                   help="the device to train on (rank r of --n_devices on cuda:r)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks (default: every card; 1 on the CPU)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron, parallel/tp.py; total "
                        "ranks = n_devices x tp x pp x sp; plain PyTorch path)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (GPipe over the ViT blocks, parallel/pp.py; "
                        "with --tp the (data, pipe, model) mesh, parallel/p3.py)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ring size (ring attention, parallel/sp.py; "
                        "with --tp the (data, seq, model) mesh, parallel/sptp.py; "
                        "exclusive with --pp)")
    p.add_argument("--fsdp", type=str, default=None, choices=["zero1", "full"],
                   help="shard the AdamW moments (zero1), or the weights too "
                        "(full; plain PyTorch path), over the ranks; needs "
                        "--n_devices > 1")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="overlap the per-epoch latest_model.pt write with "
                        "the next epoch")
    return p


def _config(args):
    overrides = {"debug": args.debug}
    if args.async_checkpoint:
        overrides["async_checkpoint"] = True
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.suffix is not None:
        overrides["suffix"] = args.suffix
    if args.fsdp is not None:
        overrides["fsdp"] = args.fsdp
    for flag, key in (("tp", "mesh_model_axis"), ("pp", "mesh_pipe_axis"),
                      ("sp", "mesh_seq_axis")):
        if getattr(args, flag) > 1:
            overrides[key] = getattr(args, flag)
    if args.n_devices:
        overrides["mesh_data_axis"] = args.n_devices
    return load_config(args.config, overrides)


def _train(args, device: str, mesh=None) -> None:
    cfg = _config(args)
    set_seeds(cfg.seed)

    from sod_tpu_torch.models.convert import load_torch_state_dict
    from sod_tpu_torch.parallel.mesh import is_main
    from sod_tpu_torch.train.trainer import Trainer

    state_dict = None
    if args.p_state_dict:
        state_dict = load_torch_state_dict(args.p_state_dict)
        print(f"Pre-trained weights are loaded from {args.p_state_dict}")
    trainer = Trainer(cfg, device=device, state_dict=state_dict,
                      debug=cfg.debug, mesh=mesh)
    if is_main(mesh):
        print(f"experiment: {define_experim_name(cfg)} -> {trainer.dir_ckpt}")
    start_epoch = 1
    if args.resume:
        start_epoch = trainer.resume()
        if is_main(mesh):
            print(f"resumed; continuing from epoch {start_epoch}")
    trainer(cfg.n_epochs, start_epoch=start_epoch)
    trainer.wait_for_checkpoints()


def _rank_main(rank: int, argv) -> None:
    """One spawned rank of ``--n_devices`` (and ``--tp/--pp/--sp``)."""
    from sod_tpu_torch.parallel.layouts import mesh_from_config
    from sod_tpu_torch.parallel.mesh import rank_device

    args = build_argparser().parse_args(argv)
    device = rank_device(args.device, rank)
    _train(args, device, mesh_from_config(_config(args), device))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    from sod_tpu_torch.parallel.layouts import cli_ranks

    # the flags win; else the config's mesh axes (sod_tpu/cli/train.py:96-135)
    cfg = _config(args)
    n_data, n = cli_ranks(args.n_devices, args.device, cfg.mesh_model_axis,
                          cfg.mesh_pipe_axis, cfg.mesh_seq_axis)
    if n > 1:
        from sod_tpu_torch.parallel.mesh import spawn_cli

        if args.n_devices is None:
            argv = [*argv, "--n_devices", str(n_data)]
        spawn_cli(_rank_main, argv, n, args.device)
        return
    _train(args, args.device)


if __name__ == "__main__":
    main()
