"""Bilateral-solver mask refinement CLI of the port (twin of
``sod_tpu/cli/refine.py``; ref ``bilateral_solver.py``).

``python -m sod_tpu_torch.cli.refine --image img.jpg --mask mask.png
[--out-soft soft.png] [--out-binary binary.png] [--device cuda]``
"""
from __future__ import annotations

import argparse

import numpy as np
from PIL import Image


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch refine")
    p.add_argument("--image", required=True, help="RGB image")
    p.add_argument("--mask", required=True,
                   help="grayscale saliency mask (same size)")
    p.add_argument("--out-soft", default="refined_soft.png")
    p.add_argument("--out-binary", default="refined_binary.png")
    p.add_argument("--sigma-spatial", type=int, default=16)
    p.add_argument("--sigma-luma", type=int, default=16)
    p.add_argument("--sigma-chroma", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the solve runs")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    from sod_tpu_torch.postprocess import bilateral_solver_output

    img = Image.open(args.image).convert("RGB")
    mask = np.asarray(Image.open(args.mask).convert("L"), np.float32) / 255.0
    if mask.shape != (img.size[1], img.size[0]):
        raise SystemExit(f"size mismatch: image {img.size[::-1]} vs mask "
                         f"{mask.shape}")
    soft, binary = bilateral_solver_output(
        img, mask, sigma_spatial=args.sigma_spatial,
        sigma_luma=args.sigma_luma, sigma_chroma=args.sigma_chroma,
        device=args.device)
    Image.fromarray((np.clip(soft, 0, 1) * 255).astype(np.uint8)).save(
        args.out_soft)
    Image.fromarray((binary * 255).astype(np.uint8)).save(args.out_binary)
    print(f"wrote {args.out_soft} and {args.out_binary}")


if __name__ == "__main__":
    main()
