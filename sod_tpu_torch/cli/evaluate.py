"""Evaluation entry point of the port (twin of ``sod_tpu/cli/evaluate.py``):

    python -m sod_tpu_torch.cli.evaluate --config configs/<yaml> \\
        --dataset_name {duts,ecssd,dut_omron} [--p_state_dict X.pt] \\
        [--batch_size 16] [--cost_type iou|f_measure|f_max|mae] \\
        [--scale_factor 2] [--debug] [--device cuda] [--gpu_id 0] [--use_gpu True]
        [--n_devices N] [--tp T] [--sp S]

yaml -> Config, seeds, the model (weights from a ``.pt`` state dict in the
reference layout or a checkpoint of the port's Trainer, else seeded random
weights; an orbax checkpoint directory is refused, as in the service), one
``Evaluator`` run on one device; prints the metric dict and writes the
per-image CSV under ``{dir_root}/eval/{experiment}``.  ``--n_devices N``
above 1 spawns N data-parallel ranks (rank r on ``cuda:r`` over NCCL, or on
the CPU over gloo), each running its rows of every batch; rank 0 prints and
writes.  ``--tp`` and ``--sp`` add the model-sharding layouts (``sod_tpu``'s
``make_mesh_2d`` / ``_sp`` / ``_sptp``; the plain PyTorch path): N x tp x sp
ranks are spawned, the heads over ``--tp`` ranks, the canvas tokens round a
ring of ``--sp``; more ranks than cards raise ``sod_tpu``'s ``ValueError``
before any rendezvous.
"""
from __future__ import annotations

import argparse
import json
import sys

from sod_tpu_torch.config import define_experim_name, load_config
from sod_tpu_torch.utils.misc import set_seeds


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch evaluate")
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--p_state_dict", type=str, default=None,
                   help="torch checkpoint: the reference's state dict or a "
                        "checkpoint written by the port's Trainer")
    p.add_argument("--dataset_name", "-dn", type=str, default="duts",
                   choices=["dut_omron", "duts", "ecssd"])
    # reference-CLI parity, unused: --device names the device
    p.add_argument("--use_gpu", type=bool, default=True)
    p.add_argument("--gpu_id", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dir_root", type=str, default=".")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--cost_type", type=str, default="iou",
                   choices=["iou", "f_measure", "f_max", "mae"])
    p.add_argument("--scale_factor", type=int, default=2,
                   help="pixel-decoder upsample factor; must divide the patch "
                        "size ({1, 2, 4, 8} at p=8; the shipped value is 2)")
    p.add_argument("--debug", "-d", action="store_true",
                   help="stop after one batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to evaluate on (rank r of --n_devices on cuda:r)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks (default: one); batch_size must "
                        "divide evenly")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (parallel/tp.py; plain PyTorch path)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ring size (ring attention over the canvas "
                        "tokens, parallel/sp.py; with --tp the (data, seq, model) mesh, "
                        "parallel/sptp.py)")
    return p


def _rank_main(rank: int, argv) -> None:
    """One spawned rank of ``--n_devices`` (and ``--tp/--sp``): the mesh of
    ``sod_tpu/cli/evaluate.py:84-97``, as the Trainer picks it."""
    from types import SimpleNamespace

    from sod_tpu_torch.parallel.layouts import mesh_from_config
    from sod_tpu_torch.parallel.mesh import rank_device

    args = build_argparser().parse_args(argv)
    device = rank_device(args.device, rank)
    axes = SimpleNamespace(mesh_data_axis=args.n_devices or 1, mesh_model_axis=args.tp,
                           mesh_pipe_axis=1, mesh_seq_axis=args.sp)
    _evaluate(args, device, mesh_from_config(axes, device))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if args.tp > 1 or args.sp > 1:
        from sod_tpu_torch.parallel.layouts import cli_ranks

        _, n = cli_ranks(args.n_devices, args.device, tp=args.tp, sp=args.sp)
    else:
        n = args.n_devices or 1
    if n > 1:
        from sod_tpu_torch.parallel.mesh import spawn_cli

        spawn_cli(_rank_main, argv, n, args.device)
        return {}
    return _evaluate(args, args.device)


def _evaluate(args, device: str, mesh=None) -> dict:
    cfg = load_config(args.config, {"seed": args.seed, "suffix": args.suffix})
    set_seeds(cfg.seed)

    import torch

    from sod_tpu_torch.models.convert import load_torch_state_dict, require_torch_checkpoint
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.parallel.mesh import is_main
    from sod_tpu_torch.train.evaluator import Evaluator

    mcfg = config_from(cfg)
    model = MaskFormer(mcfg)
    if args.p_state_dict:
        require_torch_checkpoint(args.p_state_dict)
        model.load_state_dict(load_torch_state_dict(args.p_state_dict))
        print(f"Pre-trained weights are loaded from {args.p_state_dict}")
    else:
        print("No weights given — evaluating a randomly initialised model.")
        model.load_state_dict(random_state_dict(model, cfg.seed))
    model.to(torch.device(device))

    evaluator = Evaluator(model, cfg, mcfg, batch_size=args.batch_size,
                          debug=args.debug, device=device, mesh=mesh)
    metrics = evaluator(dataset_name=args.dataset_name,
                        dir_ckpt=f"{args.dir_root}/eval/{define_experim_name(cfg)}",
                        batch_size=args.batch_size, cost_type=args.cost_type,
                        scale_factor=args.scale_factor)
    if is_main(mesh):
        print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
