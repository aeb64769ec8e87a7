"""Pseudo-mask generation entry point of the port (twin of
``sod_tpu/cli/generate_masks.py``):

    python -m sod_tpu_torch.cli.generate_masks --p_images 'dir/*.jpg' \\
        --fp out.json [--device cuda] [--cluster_type spectral|k-means] \\
        [--cluster_sizes 2 3 4] [--feature_types mocov2 swav dino] \\
        [--dino_ckpt X.pth] [--mocov2_ckpt Y.pth] [--swav_ckpt Z.pth]

Writes ``{filename: COCO RLE}`` JSON.  Runs on the card unless ``--device``
names another.  Backbones without a checkpoint get seeded random weights
(nothing is downloaded).  ``--use_gpu`` and ``--gpu_id`` are the
reference's and unused.  ``--n_devices N`` above 1 spawns N data-parallel
ranks (rank r on ``cuda:r`` over NCCL, or on the CPU over gloo) that split
each batch's images; rank 0 writes the JSON.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys

from sod_tpu_torch.utils.misc import set_seeds


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch generate-masks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--p_images", type=str, nargs="+", required=True,
                   help="image paths or glob patterns")
    p.add_argument("--fp", type=str, default="your_pseudo_masks.json")
    p.add_argument("--cluster_type", "-ct", type=str, default="spectral",
                   choices=["spectral", "k-means"])
    p.add_argument("--cluster_sizes", "-cs", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--feature_types", "-ft", type=str, nargs="+",
                   default=["mocov2", "swav", "dino"],
                   choices=["mocov2", "swav", "dino"], metavar="FT")
    p.add_argument("--patch_size", "-ps", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--scale_factor", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    # reference-CLI parity, unused: --device names the device
    p.add_argument("--use_gpu", type=bool, default=True)
    p.add_argument("--gpu_id", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to generate on (rank r of --n_devices on cuda:r)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks splitting each batch (default: one)")
    p.add_argument("--dino_ckpt", type=str, default=None)
    p.add_argument("--mocov2_ckpt", type=str, default=None)
    p.add_argument("--swav_ckpt", type=str, default=None)
    return p


def _rank_main(rank: int, argv) -> None:
    """One spawned rank of ``--n_devices``."""
    from sod_tpu_torch.parallel.mesh import make_mesh, rank_device

    args = build_argparser().parse_args(argv)
    device = rank_device(args.device, rank)
    _generate(args, device, make_mesh(args.n_devices, device))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if (args.n_devices or 1) > 1:
        from sod_tpu_torch.parallel.mesh import spawn_cli

        spawn_cli(_rank_main, argv, args.n_devices, args.device)
        return {}
    return _generate(args, args.device)


def _generate(args, device: str, mesh=None) -> dict:
    set_seeds(args.seed)

    paths = []
    for pat in args.p_images:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])

    params = {}
    for ft, ckpt in (("dino", args.dino_ckpt), ("mocov2", args.mocov2_ckpt),
                     ("swav", args.swav_ckpt)):
        if ckpt:
            from sod_tpu_torch.models.convert import (
                convert_resnet50,
                convert_vit,
                load_torch_state_dict,
            )

            sd = load_torch_state_dict(ckpt)
            params[ft] = convert_vit(sd) if ft == "dino" else convert_resnet50(sd)
            print(f"{ft} weights loaded from {ckpt}")

    from sod_tpu_torch.data.mask_generator import MaskGenerator
    from sod_tpu_torch.parallel.mesh import is_main

    gen = MaskGenerator(
        cluster_sizes=args.cluster_sizes, cluster_type=args.cluster_type,
        feature_types=args.feature_types, device=device,
        patch_size=args.patch_size, image_size=args.image_size,
        scale_factor=args.scale_factor, batch_size=args.batch_size,
        seed=args.seed, params=params, mesh=mesh)
    masks = gen(paths)
    if is_main(mesh):
        with open(args.fp, "w") as f:
            json.dump(masks, f)
        print(f"wrote {len(masks)} pseudo-masks to {args.fp}")
    return masks


if __name__ == "__main__":
    main()
