"""Offline batch prediction of the port (twin of ``sod_tpu/cli/predict.py``):
run the saliency model over a folder of images and write mask PNGs.

    python -m sod_tpu_torch.cli.predict --p_images 'photos/*.jpg' \\
        --p_state_dict selfmask_nq20.pt --out masks/ [--heatmap] \\
        [--quantize int8] [--batch_size 64] [--refine] [--device cuda]

The serving stack's exact model path (the same fused forward, objectness
argmax selection and LANCZOS restore to the original size), in static
batches of ``--batch_size`` padded with the last image.  ``--refine`` also
writes ``<stem>_refined.png``, the bilateral solver's soft mask, solved on
``--device``.  Weights come from a torch checkpoint in the reference's
layout, else seeded random weights (smoke runs only); orbax checkpoint
directories are refused as in the service.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

from sod_tpu_torch.utils.misc import set_seeds


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sod-tpu-torch predict")
    p.add_argument("--p_images", type=str, nargs="+", required=True,
                   help="image paths or glob patterns")
    p.add_argument("--out", type=str, default="predictions",
                   help="output directory for <stem>_mask.png files")
    p.add_argument("--config", "-c", type=str, default=None)
    p.add_argument("--p_state_dict", type=str, default=None,
                   help="torch checkpoint (.pt/.pth/.tar) in the reference's "
                        "layout")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--quantize", choices=["none", "int8"], default=None,
                   help="int8: W8A8 fused encoder (ops/fused_block_int8)")
    p.add_argument("--heatmap", action="store_true",
                   help="also write <stem>_heatmap.png (jet-LUT blend, "
                        "identical to the serving /predict heatmap)")
    p.add_argument("--refine", action="store_true",
                   help="also write <stem>_refined.png (bilateral-solver "
                        "refinement of the mask)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the one device to predict on")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    set_seeds(args.seed)

    paths = []
    for pat in args.p_images:
        hits = sorted(glob.glob(pat))
        if not hits:
            # a miss must fail now, not as a FileNotFoundError on the
            # literal pattern string after earlier chunks already wrote
            raise SystemExit(f"--p_images pattern matched nothing: {pat}")
        paths.extend(hits)
    # overlapping patterns must not predict (and write) an image twice:
    # the second pass would emit a spurious "<stem>_1" duplicate file
    paths = list(dict.fromkeys(paths))
    os.makedirs(args.out, exist_ok=True)

    import numpy as np
    from PIL import Image

    from sod_tpu_torch.config import Config, load_config
    from sod_tpu_torch.data.augment import resize_pil
    from sod_tpu_torch.serving.inference import _JET_LUT, SelfMaskInference

    cfg = load_config(args.config) if args.config else Config()
    if args.quantize is not None:
        cfg = cfg.replace(quantize=args.quantize)
    if not args.p_state_dict:
        print("WARNING: no weights given — predicting with a randomly "
              "initialised model (smoke runs only).")

    # the serving stack's model path (weight loading, the fused forward,
    # objectness argmax and optional int8), without its warm-up buckets or
    # micro-batcher: this CLI drives full static batches itself
    svc = SelfMaskInference(model_path=args.p_state_dict, cfg=cfg,
                            device=args.device, warmup=False)
    size = cfg.eval_image_size
    b = max(1, args.batch_size)

    t0 = time.perf_counter()
    n_done = 0
    seen: dict = {}
    for lo in range(0, len(paths), b):
        chunk = paths[lo:lo + b]
        imgs, arrs = [], []
        for p in chunk:
            img = Image.open(p).convert("RGB")
            imgs.append(img)
            arrs.append(np.asarray(resize_pil(img, (size, size), "bilinear"),
                                   np.uint8))
        # pad to the static batch (every chunk runs the same shapes)
        arr = np.stack(arrs + [arrs[-1]] * (b - len(arrs)))
        masks, _ = svc.forward_u8(arr)
        masks = np.clip(masks.cpu().numpy(), 0.0, 1.0)

        for i, (p, img) in enumerate(zip(chunk, imgs)):
            stem = os.path.splitext(os.path.basename(p))[0]
            # same stem from different directories: suffix instead of
            # silently overwriting the earlier mask.  The generated name
            # is itself reserved in `seen`, so a later real "<stem>_1"
            # input (or a second collision) can never clobber it.
            if stem in seen:
                n = 1
                while f"{stem}_{n}" in seen:
                    n += 1
                stem = f"{stem}_{n}"
            seen[stem] = True
            mask_img = Image.fromarray((masks[i] * 255).astype(np.uint8))
            mask_full = mask_img.resize(img.size, Image.LANCZOS)
            mask_full.convert("L").save(
                os.path.join(args.out, f"{stem}_mask.png"))
            if args.heatmap:
                heat = _JET_LUT[np.asarray(mask_full)]
                blended = ((np.asarray(img, np.uint16) + heat) >> 1
                           ).astype(np.uint8)
                Image.fromarray(blended).save(
                    os.path.join(args.out, f"{stem}_heatmap.png"))
            if args.refine:
                from sod_tpu_torch.postprocess import bilateral_solver_output

                soft, _ = bilateral_solver_output(
                    img, np.asarray(mask_full, np.float32) / 255.0,
                    device=args.device)
                Image.fromarray((np.clip(soft, 0, 1) * 255).astype(
                    np.uint8)).save(
                    os.path.join(args.out, f"{stem}_refined.png"))
            n_done += 1
    dt = time.perf_counter() - t0
    print(f"predicted {n_done} images -> {args.out} "
          f"({n_done / dt:.1f} img/s incl. IO)")


if __name__ == "__main__":
    main()
