#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sod_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as it passes; any failure exits non-zero:

1. card: a CUDA device of compute capability 9.0, its name and power limit
   from nvidia-smi; TF32 off for the plain versions;
2. build: nvcc builds every kernel library from the checkout, in parallel
   (the fused ViT block K1, flash attention K2, the attention half K3 and
   K5, the MLP half K4, the threshold sweep K6, the upper-bound counts K7,
   the int8 fused block K8);
3. kernel: the fused block against its plain PyTorch version at the served
   shape (B=2, 785 tokens padded to 896, d 384, 6 heads), unmasked and
   masked, and at the other head widths it is built for; then both timed
   with CUDA events at B=1 and B=8;
4. main path: the port's inference service at the full width of the
   shipped config (ViT-S/8 at 224 px, 6 decoder layers, 20 queries, bf16)
   with seeded random weights: ``model_step`` on 4 images and one B=8
   forward, the kernel's launch count (12 per forward), agreement with the
   same forward through the plain version, B=1 latency and B=8 img/s;
5. requests: three ``/predict`` requests through the web app with the
   port's service, masks decoded at the input size;
6. K2: the flash attention forward (unmasked and masked) and backward
   (dq, dk, dv) against their plain versions at N in {1, 63, 64, 65, 129},
   the train shape (B 8, 6 heads, 785 tokens) and the eval shape (B 16,
   6 heads, 2501 tokens, each image's canvas grid as its key mask), each at
   head dims 32, 64 and 128; every call run twice, equal bits required;
   forward and backward timed against the plain versions with CUDA events
   at the train shape, and the masked forward at the eval shape, each
   beside ``F.scaled_dot_product_attention`` as a yardstick;
7. train step: the live config at full width with seeded weights, one
   step through the kernels and one from the same weights and batch
   through the plain versions: loss, grad norm and update agreement, 12
   K2 launches each way per step, step time and img/s both ways, and the
   device's idle share over a profiled step;
8. Trainer: ``python -m sod_tpu_torch.cli.train``'s ``main`` on a
   64-image synthetic DUTS directory (RLE pseudo masks, yaml) for 2
   epochs, ``latest_model.pt``, then ``--resume`` for a third; then a
   learning check (scripts/learning_check.py's synthetic task, 300 steps,
   lr 2e-5, warmup steps/5, monotone poly): eval IoU must exceed 0.8; on
   the weights it trained, the script's int8 eval: the IoU through the bf16
   fused encoder (K1) and through the int8 one (K8, must exceed 0.8) and
   the IoU of their binarised masks (must exceed 0.95);
9. eval kernels at the eval shape (B=16, 400 px canvas: 2501 tokens,
   d 384): K5 and the K4 forward within one bf16 ulp of their plain
   versions (unmasked and masked), K6 on [16, 2, 400, 400] masks exactly
   equal, K7 on [16, 20, 100, 100] -> 400 px within the count of pixels
   whose plain upsampled value lies within 1e-6 of 0.5; kernel and plain
   ms (K6 at B=16 and B=4);
10. Evaluator: a 32-image synthetic DUTS-TE (200-400 px) at B=16 through
   the default path and ``use_fused_eval``, each through the kernels and
   through the plain versions: encoder-token and low-res-mask agreement,
   launch counts per batch (12 K2 + 1 K6; 12 K5 + 12 K4 + 1 K7 + 1 K6;
   12 K1 on a 224 px canvas), the 14 metric means both ways, eval img/s,
   a profile of each path; then ``python -m sod_tpu_torch.cli.evaluate``'s
   ``main`` on the directory and one Trainer epoch whose evaluation keeps
   ``best_model_duts.pt``.

11. fused-training kernels at the train shape (B=8, 785 tokens, d 384, 6
   heads; K3 on tokens padded to 896, K4 on 6280 rows padded to 6336, hidden
   1536): the K3 forward (output and both slabs it can keep) and backward
   in its three save modes, K4's save forward and both backward variants,
   every output against its plain version (bf16 outputs within two bf16
   ulps, the f32 weight and bias gradients at rel L2 <= 1e-2), the modes
   against each other, two runs of a backward bit for bit; then the
   entries the model calls, ``fused_ln_attn`` and ``fused_ln_mlp`` on
   [8, 785, 384] bf16 tokens with f32 master weights, forward and backward
   in every save mode, and ``fused_ln_attn`` on 1601 tokens (padded to
   1664), each against the same call through the plain versions (output,
   dx and every parameter's ``.grad``); kernel and plain ms in turns;
12. fused train step at full width and depth, B=8: ``use_fused_train`` and
   ``use_fused_mlp``, each one step through the kernels and one from the
   same weights through the plain versions (phase 7's bounds), 12 + 12
   launches of K3 and of K4 (of K2 and of K4) per step, the
   ``fused_save_acts`` and ``SOD_NO_SAVE_ATTN`` variants for two steps each
   with the peak device memory of a step in each save mode,
   step ms of both beside the default K2 path, and a profile of the
   ``use_fused_train`` step;
13. the CLI with ``use_fused_train`` for 2 epochs on the synthetic DUTS
   directory (192 launches of K3 and of K4 each way), and the learning
   check through the fused path: eval IoU must exceed 0.8.

Run right after phase 5, beside the bf16 service of phase 4:

14. K8: the int8 fused block against its plain version at the served shape
   (B=8, 785 tokens padded to 896, d 384), unmasked and masked, and at
   d 768 (12 heads) and d 192 (3 heads) on 200 of 256 tokens: the output
   within two bf16 ulps, and the int8 codes of each of the four quantisers
   that differ from the plain version's, counted; the row-quantise launch
   alone on f32 rows (codes and scales equal) and the s8 product launch
   alone against ``torch._int_mm`` with the same epilogue (equal; both
   timed, a yardstick); K8 against K1 on the same block (the quantisation
   error); K8, its plain version and K1 timed in turns at B=1 and B=8;
15. int8 serving: the service with ``quantize: int8`` booted as phase 4's,
   12 K8 launches per forward and none of K1, agreement with the same
   service through the plain version and, printed, with the bf16 service on
   the same weights (objectness correlation, binarised-mask IoU); B=1
   latency and B=8 img/s of both services in turns; a profile of the int8
   B=8 forward with K8's share; three ``/predict`` requests; ``python -m
   sod_tpu_torch.cli.predict``'s ``main`` with ``--quantize int8`` over five
   PNGs (two with one stem) in batches of 4, its files checked.

The line before the last is the kernel report (JSON): each kernel's launches
on its path, max_abs_err, ms, plain_ms, bound_ms (the larger of its
operations over the card's dense peak for their type (bf16; s8 for K8's
projections; f32 for K6 and K7) and its bytes over the memory rate, from
the shapes of this run), bound_by and library_ms (one PyTorch call that
computes the same function, timed as a yardstick only, else null).  The
last line is ``{"ok": true, "device": {...}}``.  Needs no network and no
jax.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "duts-dino-k234-nq20-224-swav-mocov2-dino-p16-sr10100.yaml")
KERNEL = {"name": "fused_vit_block", "route": "cuda",
          "source": "sod_tpu_torch/csrc/fused_block.cu",
          "replaces": "sod_tpu/ops/fused_block.py:42"}
K2 = {"route": "cuda", "source": "sod_tpu_torch/csrc/flash_attention.cu"}
K2_FWD = dict(K2, name="flash_attention_forward",
              replaces="sod_tpu/ops/flash_attention.py:54")
K2_BWD = dict(K2, name="flash_attention_backward",
              replaces="sod_tpu/ops/flash_attention.py:145")
K2_FWD_EVAL = dict(K2, name="flash_attention_forward_masked_eval_shape",
                   replaces="sod_tpu/ops/flash_attention.py:70")
# kernel vs plain version (bf16 output, unit-scale activations): two bf16
# ulps at |x| < 8 (H100 run: max_abs 0.0156, corr 0.99999995)
KERNEL_MAX_ABS, KERNEL_MIN_CORR = 0.0625, 0.99999
# main path vs plain version: objectness (sigmoid) and the selected mask
# (sigmoid; model_step's is quantized to uint8).  Both paths round to bf16
# at the same points; f32 sums in another order flip single bf16 roundings,
# which 12 blocks and the random-weight mask logits (|logit| ~ 10) amplify
# at a few pixels (H100 run: objectness <= 5.6e-4, mask max 0.133, mean
# 0.0048)
PATH_OBJ_TOL, PATH_MASK_MAX, PATH_MASK_MEAN = 0.005, 0.3, 0.01
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor
# cores, f32 outside them, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_INT8_OPS = 1979e12                 # dense s8 tensor-core products


def roofline(flops: float, n_bytes: float, peak_flops: float = PEAK_BF16_FLOPS,
             other_ops_ms: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type (``other_ops_ms``: the time of operations of
    a second type at their own peak, added to it) and the bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops = flops / peak_flops * 1e3 + other_ops_ms
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def block_cost(rows: int, images: int, n: int, d: int, hidden: int) -> dict:
    """FLOPs of the pieces of a ViT block over ``rows`` = images x n real
    tokens (products only: 2 per multiply-add) and its bf16 weight bytes."""
    return {"qkv": 2 * rows * d * 3 * d, "scores": 2 * images * n * n * d,
            "proj": 2 * rows * d * d, "fc": 2 * rows * d * hidden,
            "w_attn": 2 * (4 * d * d + 6 * d), "w_mlp": 2 * (2 * d * hidden + 3 * d + hidden)}


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def card_check():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device. This script runs the port on "
                 "an NVIDIA H100 and has no CPU fallback.")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        sys.exit(f"chip_smoke: needs a Hopper card (compute capability "
                 f"9.0), found {cap} on {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(1, f"card {torch.cuda.get_device_name(0)}, capability {cap}, "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}")


LIBRARIES = ("fused_block", "flash_attention", "fused_attn", "fused_mlp",
             "fsweep", "fused_ub", "fused_block_int8")


def build_kernels():
    """Every library at once: one nvcc per source, started together."""
    from sod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    errors = []

    def build(name):
        try:
            _build.load(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,)) for n in LIBRARIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name in LIBRARIES:
        print(f"  {name}:")
        print("\n".join(ptxas_report(_build.library_path(name) + ".log")))
    phase(2, f"built sod_tpu_torch/csrc/{{{','.join(LIBRARIES)}}}.cu in "
             f"{time.perf_counter() - t0:.1f} s (ptxas report above: "
             f"registers, stack and spills per kernel)")


def ptxas_report(log_path: str):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    name with template arguments, registers, stack and spills."""
    import re

    lines, name, frame = [], "?", ""
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                name = _kernel_name(m.group(1))
            elif "stack frame" in ln:
                frame = ln.strip()
            elif "Used" in ln:
                lines.append(f"  {name}: {ln.split(':', 1)[1].strip()}; {frame}")
    return lines


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_kernel<64>`` from its mangled name: the length-prefixed
    identifier ending in ``_kernel``, then the integer template arguments."""
    import re

    for i in range(len(mangled)):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            start = i + digits.end()
            ident = mangled[start:start + int(digits.group())]
            if ident.endswith("_kernel"):
                args = re.findall(r"L[ib](\d+)E", mangled[start:])
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def make_block(rng, d: int, n_heads: int, perturbed: bool, dtype=None):
    """A ViT-S block on the card (bf16 unless ``dtype``), weights drawn as
    sod_tpu's vit_init draws them (N(0, 0.02) linears, zero biases,
    LayerNorm ones and zeros); with ``perturbed``, biases and LayerNorm
    parameters are random too, so a misplaced bias or LN parameter shows."""
    import torch

    from sod_tpu_torch.models.vit import Block, ViTConfig

    blk = Block(ViTConfig(embed_dim=d, n_heads=n_heads, depth=1))
    sd = {}
    for name, p in blk.state_dict().items():
        shape = tuple(p.shape)
        if name.startswith("norm"):
            a = np.ones(shape) if name.endswith("weight") else np.zeros(shape)
            if perturbed:
                a = a + rng.normal(0, 0.1, shape)
        elif name.endswith("weight"):
            a = rng.normal(0, 0.02, shape)
        else:
            a = rng.normal(0, 0.02, shape) if perturbed else np.zeros(shape)
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))
    blk.load_state_dict(sd)
    return blk.to(device="cuda", dtype=dtype or torch.bfloat16)


def errors(got, ref):
    a, b = got.float().flatten(), ref.float().flatten()
    max_abs = float((a - b).abs().max())
    rel_l2 = float((a - b).norm() / b.norm())
    corr = float(np.corrcoef(a.cpu().numpy(), b.cpu().numpy())[0, 1])
    return max_abs, rel_l2, corr


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_check():
    import torch

    from sod_tpu_torch.ops import fused_block as fb

    b, n_real, n_pad, d, h = 2, 785, 896, 384, 6
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, n_pad, d), np.float32)
                         ).to(device="cuda", dtype=torch.bfloat16)
    key_mask = torch.from_numpy(rng.random((b, n_pad)) > 0.3).cuda()
    key_mask[:, 0] = True
    worst = 0.0
    with torch.inference_mode():
        for name, perturbed, mask in (("unmasked, vit_init weights", False, None),
                                      ("unmasked, random biases/LN", True, None),
                                      ("masked, random biases/LN", True, key_mask)):
            blk = make_block(rng, d, h, perturbed)
            got = fb.fused_vit_block(x, blk, h, n_real, key_mask=mask)
            torch.cuda.synchronize()
            ref = fb.fused_vit_block_reference(x, blk, h, n_real, key_mask=mask)
            max_abs, rel_l2, corr = errors(got[:, :n_real], ref[:, :n_real])
            ok = bool(torch.isfinite(got).all()) and max_abs <= KERNEL_MAX_ABS \
                and corr > KERNEL_MIN_CORR
            print(f"  {name}: max_abs {max_abs:.6g} rel_l2 {rel_l2:.6g} "
                  f"corr {corr:.9f} -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version ({name})")
            worst = max(worst, max_abs)

        # the other head widths the kernel is built for (32, 128), small
        for dd, hh in ((128, 4), (256, 2)):
            blk = make_block(rng, dd, hh, True)
            xs = torch.from_numpy(rng.standard_normal((2, 128, dd), np.float32)
                                  ).to(device="cuda", dtype=torch.bfloat16)
            ks = key_mask[:, :128].contiguous()
            got = fb.fused_vit_block(xs, blk, hh, 100, key_mask=ks)
            torch.cuda.synchronize()
            ref = fb.fused_vit_block_reference(xs, blk, hh, 100, key_mask=ks)
            max_abs, rel_l2, corr = errors(got[:, :100], ref[:, :100])
            print(f"  head dim {dd // hh}, masked: max_abs {max_abs:.6g} rel_l2 "
                  f"{rel_l2:.6g} corr {corr:.9f}", flush=True)
            if not (max_abs <= KERNEL_MAX_ABS and corr > KERNEL_MIN_CORR):
                raise AssertionError(f"kernel disagrees at head dim {dd // hh}")

        timings = {}
        blk = make_block(rng, d, h, True)
        for bb in (1, 8):
            xb = torch.from_numpy(rng.standard_normal((bb, n_pad, d), np.float32)
                                  ).to(device="cuda", dtype=torch.bfloat16)
            kern = lambda: fb.fused_vit_block(xb, blk, h, n_real)
            plain = lambda: fb.fused_vit_block_reference(xb, blk, h, n_real)
            # in turns on one card: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern, plain))
            timings[bb] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"  B={bb}: kernel {timings[bb][0]:.4f} ms, plain "
                  f"{timings[bb][1]:.4f} ms per block call", flush=True)
    phase(3, f"fused block matches its plain version (max_abs <= "
             f"{KERNEL_MAX_ABS}, corr > {KERNEL_MIN_CORR})")
    return worst, timings


def plain_encoder(vit, x):
    """The fused encoder path of ``vit_apply`` with the kernel's plain
    version in place of the kernel (for the ``encoder_apply`` hook): K8's
    where the encoder carries quantised blocks, else K1's."""
    import torch.nn.functional as F

    from sod_tpu_torch.models.vit import LN_EPS, prepare_tokens
    from sod_tpu_torch.ops.fused_block import fused_vit_block_reference
    from sod_tpu_torch.ops.fused_block_int8 import fused_vit_block_int8_reference

    tokens, _ = prepare_tokens(vit, x)
    n = tokens.shape[1]
    out = F.pad(tokens, (0, 0, 0, -(-n // 128) * 128 - n))
    blocks_q = getattr(vit, "blocks_q", None)
    for i, blk in enumerate(vit.blocks):
        if blocks_q is not None:
            out = fused_vit_block_int8_reference(out, blocks_q[i], vit.cfg.n_heads,
                                                 n, eps=LN_EPS)
        else:
            out = fused_vit_block_reference(out, blk, vit.cfg.n_heads, n,
                                            eps=LN_EPS)
    return vit.norm(out[:, :n])


def compare_with_plain(svc, u8, masks, objs):
    """Gaps of the kernel path's results (``masks`` [B, h, w] in 0..1,
    ``objs`` [B, Q]) to the plain path at the query the kernel path chose:
    objectness max, mask max and mean; and how many choices agree."""
    import torch

    with torch.inference_mode():
        x = svc.prep(torch.from_numpy(u8).cuda())
        out = svc.model(x, encoder_apply=plain_encoder)
    obj_p = out["objectness"][:, -1, :, 0].float().cpu().numpy()
    mask_p = out["mask_pred"][:, -1].float().cpu().numpy()
    best = objs.argmax(axis=1)
    rows = np.arange(len(best))
    gap = np.abs(masks - np.clip(mask_p[rows, best], 0, 1))
    return (float(np.abs(objs - obj_p).max()), float(gap.max()),
            float(gap.mean()), int((obj_p.argmax(axis=1) == best).sum()))


def host_ms(fn, iters: int) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronize."""
    import torch

    fn()
    ts = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def plain_forward(svc, u8):
    """``svc``'s forward with the encoder through the plain versions."""
    import torch

    with torch.inference_mode():
        svc.model(svc.prep(torch.from_numpy(u8).cuda()), encoder_apply=plain_encoder)


def main_path():
    import torch

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.ops import fused_block as fb
    from sod_tpu_torch.serving.inference import SelfMaskInference

    cfg = load_config(CONFIG)
    t0 = time.perf_counter()
    svc = SelfMaskInference(cfg=cfg, device="cuda")
    print(f"  service up in {time.perf_counter() - t0:.1f} s (weights seed "
          f"{cfg.seed}, {cfg.compute_dtype}, micro-batching "
          f"{svc.micro_batching})", flush=True)
    rng = np.random.default_rng(1)
    size = cfg.eval_image_size
    imgs = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)

    fb.launches = 0
    steps = [svc.model_step(im) for im in imgs]
    m8, o8 = svc.forward_u8(batch)
    m8, o8 = m8.cpu().numpy(), o8.cpu().numpy()
    launches = fb.launches
    n_forwards = len(imgs) + 1
    depth = svc.mcfg.vit.depth
    print(f"  fused block launches: {launches} over {n_forwards} forwards",
          flush=True)
    if launches != depth * n_forwards:
        raise AssertionError(f"expected {depth} launches per forward, got "
                             f"{launches} for {n_forwards} forwards")

    mask1 = np.stack([m for m, _ in steps]).astype(np.float32) / 255.0
    obj1 = np.stack([o for _, o in steps])
    n_q = svc.mcfg.n_queries
    side = size // svc.mcfg.vit.patch_size * svc.mcfg.scale_factor
    for m, o in steps + [(m8, o8)]:
        if not (np.isfinite(o).all() and o.shape[-1] == n_q
                and m.shape[-2:] == (side, side)):
            raise AssertionError(f"bad output: mask {m.shape}, obj {o.shape}")
    checks = [(f"model_step image {i}",
               compare_with_plain(svc, imgs[i:i + 1], mask1[i:i + 1], obj1[i:i + 1]))
              for i in range(len(imgs))]
    checks.append(("forward B=8", compare_with_plain(svc, batch, m8, o8)))
    for name, (obj_err, mask_max, mask_mean, agree) in checks:
        print(f"  {name}: objectness max_abs {obj_err:.6g}, mask max_abs "
              f"{mask_max:.6g} mean_abs {mask_mean:.6g}, argmax agrees "
              f"{agree}", flush=True)
        if obj_err > PATH_OBJ_TOL or mask_max > PATH_MASK_MAX \
                or mask_mean > PATH_MASK_MEAN:
            raise AssertionError(f"main path disagrees with the plain version ({name})")

    one = imgs[:1]
    lat = {"kernel B=1 ms": host_ms(lambda: svc.forward_u8(one), 30),
           "plain B=1 ms": host_ms(lambda: plain_forward(svc, one), 10),
           "model_step B=1 ms": host_ms(lambda: svc.model_step(imgs[0]), 30)}
    b8 = host_ms(lambda: svc.forward_u8(batch), 20)
    p8 = host_ms(lambda: plain_forward(svc, batch), 5)
    lat["kernel B=8 img/s"] = 8e3 / b8
    lat["plain B=8 img/s"] = 8e3 / p8
    print("  " + ", ".join(f"{k} {v:.3f}" for k, v in lat.items()), flush=True)
    phase(4, f"main path: {depth} launches per forward, agrees with the "
             f"plain version (objectness <= {PATH_OBJ_TOL}, mask max <= "
             f"{PATH_MASK_MAX}, mean <= {PATH_MASK_MEAN}), B=1 {lat['kernel B=1 ms']:.3f} ms, "
             f"B=8 {lat['kernel B=8 img/s']:.1f} img/s")
    return svc, cfg, launches


class Client:
    """Minimal WSGI client with cookies (as tests/test_serving.py's)."""

    def __init__(self, app):
        self.app, self.cookies = app, {}

    def request(self, method, path, json_body=None, files=None):
        body, ctype = b"", ""
        if json_body is not None:
            body, ctype = json.dumps(json_body).encode(), "application/json"
        elif files:
            bd = "smokeboundary"
            parts = [f"--{bd}\r\nContent-Disposition: form-data; name=\"{k}\"; "
                     f"filename=\"{fn}\"\r\nContent-Type: application/octet-stream"
                     f"\r\n\r\n".encode() + data + b"\r\n"
                     for k, (fn, data) in files.items()]
            body = b"".join(parts) + f"--{bd}--\r\n".encode()
            ctype = f"multipart/form-data; boundary={bd}"
        path_only, _, query = path.partition("?")
        environ = {"REQUEST_METHOD": method, "PATH_INFO": path_only,
                   "QUERY_STRING": query, "CONTENT_TYPE": ctype,
                   "CONTENT_LENGTH": str(len(body)),
                   "wsgi.input": io.BytesIO(body), "REMOTE_ADDR": "127.0.0.1",
                   "HTTP_COOKIE": "; ".join(f"{k}={v}" for k, v in self.cookies.items())}
        status = {}

        def start_response(st, headers):
            status["code"] = int(st.split()[0])
            for k, v in headers:
                if k == "Set-Cookie":
                    name, _, rest = v.partition("=")
                    self.cookies[name] = rest.split(";")[0]

        raw = b"".join(self.app(environ, start_response))
        try:
            return status["code"], json.loads(raw)
        except ValueError:
            return status["code"], raw


def requests_phase(svc, cfg):
    predict_requests(svc, cfg, "K1")
    phase(5, "3 /predict requests answered through the port's service")


def predict_requests(svc, cfg, kernel: str):
    """Three ``/predict`` requests through the web app with ``svc``; each
    must launch ``kernel`` (a key of ``launch_counts``) once per block."""
    import base64

    from PIL import Image

    from sod_tpu_torch.serving.app import create_app
    from sod_tpu_torch.serving.db import Database

    with tempfile.TemporaryDirectory() as tmp:
        app = create_app(cfg=cfg, db=Database(":memory:"), load_model=False,
                         upload_dir=tmp, secret_key="smoke")
        app.inference = svc
        c = Client(app)
        st, r = c.request("POST", "/user_signup", json_body={
            "name": "smoke", "email": "smoke@example.com", "password": "pw",
            "phone": ""})
        assert st == 200, (st, r)
        c.request("GET", r["verify_url"])
        rng = np.random.default_rng(3)
        before = launch_counts()[kernel]
        for h, w in ((240, 320), (224, 224), (150, 380)):
            img = np.zeros((h, w, 3), np.uint8) + rng.integers(0, 60, (1, 1, 3), dtype=np.uint8)
            img[h // 4: 3 * h // 4, w // 3: 2 * w // 3] = rng.integers(150, 256, 3, dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            t0 = time.perf_counter()
            st, r = c.request("POST", "/predict", files={"image": ("im.png", buf.getvalue())})
            dt = (time.perf_counter() - t0) * 1e3
            if st != 200 or not r.get("success"):
                raise AssertionError(f"/predict answered {st}: {r}")
            mask = Image.open(io.BytesIO(base64.b64decode(r["mask"])))
            heat = Image.open(io.BytesIO(base64.b64decode(r["heatmap"])))
            if mask.size != (w, h) or heat.size != (w, h) \
                    or len(r["objectness_scores"]) != svc.mcfg.n_queries:
                raise AssertionError(f"/predict returned mask {mask.size}, heatmap "
                                     f"{heat.size} for a {w}x{h} image")
            print(f"  /predict {w}x{h}: 200, mask {mask.size}, {dt:.1f} ms", flush=True)
        n_launches = launch_counts()[kernel] - before
        if n_launches != 3 * svc.mcfg.vit.depth:
            raise AssertionError(f"/predict launched {kernel} {n_launches} times "
                                 f"for 3 requests")


# K2 vs its plain versions at the train shape (bf16 outputs of magnitude
# < 1): both round at the same points, so they differ by single bf16 ulp
# flips from f32 sums taken in another order (first H100 run: max_abs
# forward 0.00098, dq 0.00049, dk 0.00195, dv 0.00098; rel_l2 <= 1.6e-4;
# corr >= 0.99999999)
K2_MAX_ABS, K2_MAX_REL_L2, K2_MIN_CORR = 0.0078125, 1e-3, 0.99999
K2_HEAD_DIMS = (32, 64, 128)
K2_TRAIN_SHAPE = (8, 6, 785, 64)         # the default train step's attention
# default evaluation: B=16 on a 400 px canvas, 50 x 50 patches + CLS, each
# image's own grid valid (a key mask per image, first key valid)
K2_EVAL_SHAPE = (16, 6, 2501, 64)
# phase 6's (B, H, N), each at every head dim: one key, around the 64-row
# tile edge, two tiles and a bit, the train shape, the eval shape
K2_SHAPES = tuple((2, 3, n) for n in (1, 63, 64, 65, 129)) + (
    K2_TRAIN_SHAPE[:3], K2_EVAL_SHAPE[:3])


def k2_bound(b: int, h: int, n: int, d: int, valid_keys=None) -> dict:
    """The least time the card could take for K2 on [b, h, n, d] bf16:
    {"fwd": roofline, "bwd": roofline}.  ``valid_keys``: unmasked keys summed
    over the batch (default b * n).  Forward: q.k^T and p.v over the valid
    keys (4 flops per query, key and channel), q, k, v read and o written.
    Backward: five such products, q, k, v, do read and dq, dk, dv written."""
    pairs = h * d * n * (b * n if valid_keys is None else valid_keys)
    act = 2 * b * h * n * d
    return {"fwd": roofline(4 * pairs, 4 * act), "bwd": roofline(10 * pairs, 7 * act)}


def _k2_inputs(rng, shape):
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(device="cuda", dtype=torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.5
                          ).to(device="cuda", dtype=torch.bfloat16)
    mask = torch.from_numpy(rng.random((shape[0], shape[2])) > 0.3).cuda()
    mask[:, 0] = True
    return q, k, v, do, mask


def _canvas_mask(rng, b: int, n: int):
    """The Evaluator's key mask on a square canvas of n - 1 patches: CLS,
    then each image's own grid of 25..side patches a side."""
    side = int(round((n - 1) ** 0.5))
    grid = np.zeros((b, side, side), bool)
    for i in range(b):
        gh, gw = rng.integers(side // 2, side + 1, 2)
        grid[i, :gh, :gw] = True
    return np.concatenate([np.ones((b, 1), bool), grid.reshape(b, -1)], 1)


def k2_check():
    """Phase 6: returns the worst forward and backward max_abs, the times
    {name: (kernel ms, plain ms)} at the train shape and, under "eval", the
    masked forward's at the eval shape with its bound on the valid keys."""
    import torch
    import torch.nn.functional as F

    from sod_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(6)
    worst = {"fwd": 0.0, "bwd": 0.0}

    def check(name, kind, got, ref):
        max_abs, rel_l2, corr = errors(got, ref)
        ok = bool(torch.isfinite(got).all()) and max_abs <= K2_MAX_ABS
        if float(ref.float().abs().max()) > 0:
            ok = ok and rel_l2 <= K2_MAX_REL_L2 and corr > K2_MIN_CORR
        # else: a zero reference (dq and dk of a single key) has no relative
        # error or correlation; max_abs holds it
        print(f"  {name}: max_abs {max_abs:.6g} rel_l2 {rel_l2:.6g} corr "
              f"{corr:.9f} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version ({name})")
        worst[kind] = max(worst[kind], max_abs)

    for b, h, n in K2_SHAPES:
        for d in K2_HEAD_DIMS:
            q, k, v, do, mask = _k2_inputs(rng, (b, h, n, d))
            if (b, h, n) == K2_EVAL_SHAPE[:3]:
                mask = torch.from_numpy(_canvas_mask(rng, b, n)).cuda()
            scale = d ** -0.5
            tag = f"B{b} H{h} N{n} d{d}"
            runs = []
            for _ in range(2):
                o, m, l = fa.flash_forward_cuda(q, k, v, scale)
                om, _, _ = fa.flash_forward_cuda(q, k, v, scale, mask)
                runs.append((o, m, l, om, *fa.flash_backward_cuda(q, k, v, do, m, l, scale)))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                raise AssertionError(f"K2 {tag}: two runs on the same inputs differ")
            o, _, _, om, *grads = runs[0]
            check(f"{tag} forward", "fwd", o, fa.flash_forward_reference(q, k, v, scale))
            check(f"{tag} forward masked", "fwd", om,
                  fa.flash_forward_reference(q, k, v, scale, mask))
            ref = fa.flash_backward_reference(q, k, v, do, scale)
            for gname, got, want in zip(("dq", "dk", "dv"), grads, ref):
                check(f"{tag} backward {gname}", "bwd", got, want)
            del runs, o, om, grads, ref, q, k, v, do
    print(f"  forward, masked forward and backward ran twice at each of "
          f"{len(K2_SHAPES) * len(K2_HEAD_DIMS)} shapes: equal bits", flush=True)

    q, k, v, do, _ = _k2_inputs(rng, K2_TRAIN_SHAPE)
    _, m, l = fa.flash_forward_cuda(q, k, v, 0.125)
    pairs = {"fwd": (lambda: fa.flash_forward_cuda(q, k, v, 0.125),
                     lambda: fa.flash_forward_reference(q, k, v, 0.125)),
             "bwd": (lambda: fa.flash_backward_cuda(q, k, v, do, m, l, 0.125),
                     lambda: fa.flash_backward_reference(q, k, v, do, 0.125))}
    timings = {}
    for name, (kern, plain) in pairs.items():
        # in turns on one card: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern, plain))
        timings[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {name} at B=8 H=6 N=785 d=64: kernel {timings[name][0]:.4f} ms, "
              f"plain {timings[name][1]:.4f} ms per call", flush=True)

    # the library's call for the same function, as a yardstick only: nothing
    # in the port calls it
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125)  # noqa: E731
    out_l = sdpa()
    lib_abs = errors(out_l.detach(), fa.flash_forward_reference(q, k, v, 0.125))[0]
    with torch.no_grad():
        timings["fwd_lib"] = cuda_ms(sdpa, 20)
    timings["bwd_lib"] = cuda_ms(
        lambda: torch.autograd.grad(out_l, (ql, kl, vl), do, retain_graph=True), 20)
    print(f"  F.scaled_dot_product_attention on the same tensors (yardstick): forward "
          f"{timings['fwd_lib']:.4f} ms, its autograd backward {timings['bwd_lib']:.4f} ms "
          f"(max_abs {lib_abs:.6g} to the plain forward)", flush=True)
    del q, k, v, do, m, l, ql, kl, vl, out_l

    # the masked forward at the eval shape, as default evaluation calls it
    b, h, n, d = K2_EVAL_SHAPE
    q, k, v, _, _ = _k2_inputs(rng, K2_EVAL_SHAPE)
    mask = torch.from_numpy(_canvas_mask(rng, b, n)).cuda()
    valid = int(mask.sum())
    attn_mask = mask[:, None, None, :]
    kern = lambda: fa.flash_forward_cuda(q, k, v, 0.125, mask)  # noqa: E731
    plain = lambda: fa.flash_forward_reference(q, k, v, 0.125, mask)  # noqa: E731
    with torch.no_grad():
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=0.125), 5)
    bound = k2_bound(b, h, n, d, valid)["fwd"]
    timings["eval"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                       "bound": bound}
    print(f"  masked forward at B={b} H={h} N={n} d={d}, {valid} of {b * n} keys valid: "
          f"kernel {(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms, "
          f"F.scaled_dot_product_attention with attn_mask (yardstick) {lib:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}", flush=True)
    phase(6, f"K2 forward (unmasked, masked) and backward match their plain versions at "
             f"N in {sorted({n for _, _, n in K2_SHAPES})} and head dims "
             f"{list(K2_HEAD_DIMS)} (max_abs <= {K2_MAX_ABS}, rel_l2 <= {K2_MAX_REL_L2}, "
             f"corr > {K2_MIN_CORR}); two runs give equal bits")
    return worst, timings


class _PlainFlash:
    """K2's plain versions as the autograd function of the encoder's
    attention, on CUDA tensors (the kernels' twin for phase 7)."""

    def __enter__(self):
        import torch

        from sod_tpu_torch.ops import attention
        from sod_tpu_torch.ops import flash_attention as fa

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, scale, key_mask):
                ctx.save_for_backward(q, k, v)
                ctx.scale = scale
                return fa.flash_forward_reference(q, k, v, scale, key_mask)

            @staticmethod
            def backward(ctx, do):
                return (*fa.flash_backward_reference(*ctx.saved_tensors, do,
                                                     ctx.scale), None, None)

        self._module, self._kernel = attention, attention.flash_attention
        attention.flash_attention = lambda q, k, v, scale, key_mask=None: \
            Fn.apply(q, k, v, scale, key_mask)
        return self

    def __exit__(self, *exc):
        self._module.flash_attention = self._kernel


def synthetic_batch(rng, b: int, size: int, m: int):
    """A collate_train-shaped uint8 batch: a bright box on a dark noisy
    ground per image, its mask as GT row 0, the other rows padding."""
    images = (rng.random((b, size, size, 3)) * 50).astype(np.uint8)
    gts = np.zeros((b, m, size, size), np.uint8)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        h0, w0 = rng.integers(size // 11, size // 2, 2)
        hh, ww = rng.integers(size // 4, size // 2, 2)
        images[i, h0:h0 + hh, w0:w0 + ww] += 170
        gts[i, 0, h0:h0 + hh, w0:w0 + ww] = 1
        valid[i, 0] = True
    return {"image": images, "gt_masks": gts, "gt_valid": valid,
            "labels": rng.integers(0, 4, b).astype(np.int32)}


def _to_cuda(batch):
    import torch

    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


# train step through the kernels vs through K2's plain versions, one step
# from the same weights and batch: bf16 rounding flips inside attention
# move the loss and grad norm slightly, and Adam's first step maps each
# gradient element that is small against them to a sign-sized update, so
# the update vectors correlate but do not agree elementwise (first H100
# run: loss rel 1.0e-4, grad_norm rel 1.4e-3, update corr 0.9967)
STEP_LOSS_RTOL, STEP_GNORM_RTOL, STEP_MIN_UPDATE_CORR = 1e-3, 1e-2, 0.99


def train_step_check():
    """Phase 7: returns the step times and the profile numbers."""
    import torch

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.ops import flash_attention as fa
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg = load_config(CONFIG)
    mcfg = config_from(cfg)
    if not mcfg.vit.use_flash:
        raise AssertionError("the live config must train through K2")
    sd = random_state_dict(MaskFormer(mcfg), cfg.seed)
    runs = {}
    for name in ("kernel", "plain"):
        model = MaskFormer(mcfg)
        model.load_state_dict(sd)
        model.cuda()
        opt = build_optimizer(cfg, model.parameters(), n_iters_per_epoch=100)
        runs[name] = (model, make_train_step(cfg, model, opt))
    batch = _to_cuda(synthetic_batch(np.random.default_rng(7), cfg.batch_size,
                                     cfg.train_image_size, cfg.max_gt_masks))

    before = {k: v.detach().clone() for k, v in runs["kernel"][0].state_dict().items()}
    fa.fwd_launches = fa.bwd_launches = 0
    mk = runs["kernel"][1](batch)
    torch.cuda.synchronize()
    launches = (fa.fwd_launches, fa.bwd_launches)
    with _PlainFlash():
        mp = runs["plain"][1](batch)
    torch.cuda.synchronize()
    if fa.fwd_launches != launches[0] or fa.bwd_launches != launches[1]:
        raise AssertionError("the plain step launched K2")
    depth = mcfg.vit.depth
    print(f"  K2 launches in one step: forward {launches[0]}, backward "
          f"{launches[1]} (expected {depth} each)", flush=True)
    if launches != (depth, depth):
        raise AssertionError(f"expected {depth} K2 launches each way per step, "
                             f"got {launches}")
    mk = {k: float(v) for k, v in mk.items()}
    mp = {k: float(v) for k, v in mp.items()}
    print("  kernel step: " + ", ".join(f"{k} {v:.6g}" for k, v in mk.items()))
    print("  plain step:  " + ", ".join(f"{k} {v:.6g}" for k, v in mp.items()))
    if not all(np.isfinite(list(mk.values()))):
        raise AssertionError("non-finite train metrics")
    upd_k = torch.cat([(v - before[k]).flatten() for k, v in
                       runs["kernel"][0].state_dict().items()])
    upd_p = torch.cat([(v - before[k]).flatten() for k, v in
                       runs["plain"][0].state_dict().items()])
    corr = float(np.corrcoef(upd_k.cpu().numpy(), upd_p.cpu().numpy())[0, 1])
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    gnorm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / abs(mp["grad_norm"])
    print(f"  kernel vs plain: loss rel {loss_rel:.3g}, grad_norm rel "
          f"{gnorm_rel:.3g}, update corr {corr:.6f}, |update| max "
          f"{float(upd_k.abs().max()):.3g}", flush=True)
    if not (loss_rel <= STEP_LOSS_RTOL and gnorm_rel <= STEP_GNORM_RTOL
            and corr > STEP_MIN_UPDATE_CORR):
        raise AssertionError("the kernel step disagrees with the plain step")

    def step_ms(name, n):
        _, step = runs[name]
        step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    times = {}
    for name, n in (("kernel", 10), ("plain", 5)):
        with (_PlainFlash() if name == "plain" else contextlib.nullcontext()):
            times[name] = step_ms(name, n)
    b = cfg.batch_size
    print(f"  step at B={b}: kernel {times['kernel']:.3f} ms "
          f"({b * 1e3 / times['kernel']:.1f} img/s), plain "
          f"{times['plain']:.3f} ms ({b * 1e3 / times['plain']:.1f} img/s)",
          flush=True)
    prof = profile_steps(runs["kernel"][1], batch, 3, times["kernel"])
    phase(7, f"train step at full width: {depth}+{depth} K2 launches, agrees "
             f"with the plain step (loss rel <= {STEP_LOSS_RTOL}, grad_norm rel "
             f"<= {STEP_GNORM_RTOL}, update corr > {STEP_MIN_UPDATE_CORR}), "
             f"{times['kernel']:.1f} ms/step")
    return times, prof


def profile_steps(step, batch, n: int, step_ms: float, unit: str = "step", watch=None):
    """torch.profiler over ``n`` steps: device busy ms per step (sum of the
    CUDA kernels' times; one stream, so no overlap) and the idle share
    against ``step_ms``, the step's time with the profiler off (the
    profiler's own host cost stretches the profiled steps).  ``unit`` names
    a step in the printout; ``watch``: {label: substrings of kernel names}
    whose device time is printed too and returned as ``watched``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        print("  profiler: no device time recorded (idle share not measured)")
        return {"busy_ms": None, "idle_share": None}
    idle = 1 - busy / step_ms
    print(f"  profile over {n} {unit}s: device busy {busy:.3f} ms/{unit}, idle "
          f"share {idle:.3f} of the {step_ms:.3f} ms unprofiled {unit} "
          f"(profiled wall {wall:.3f} ms/{unit}), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/{unit}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms/{unit} "
              f"x{e.count // n:<5d} {e.key[:90]}")
    groups = {"the port's kernels": ("flash_", "gemm_kernel", "gemm_nn_kernel",
                                     "gemm_tn_kernel", "attention_kernel", "attn_bwd_",
                                     "ln_rows_", "ln_bwd_", "reduce_partials_",
                                     "quant_rows_", "sweep_", "ub_count"),
              "cuBLAS GEMMs": ("gemm", "xmma", "cutlass"), "copies and casts": ("copy",)}
    shares = {g: 0.0 for g in (*groups, "other")}
    for e in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), "other")
        shares[g] += e.self_device_time_total / 1e3 / n
    print("  device time by kind: " + ", ".join(
        f"{g} {v:.3f} ms ({v / busy:.1%})" for g, v in shares.items()))
    watched = {label: sum(e.self_device_time_total for e in kernels
                          if any(k in e.key for k in keys)) / 1e3 / n
               for label, keys in (watch or {}).items()}
    for label, v in watched.items():
        print(f"  {label}: {v:.3f} ms/{unit} ({v / busy:.1%} of device time)")
    return {"busy_ms": busy, "idle_share": idle, "watched": watched}


def write_duts(root: str, n: int, size: int) -> str:
    """A synthetic DUTS-TR directory (JPEG images, one bright box each) and
    its RLE pseudo-mask JSON; returns the JSON's path."""
    from PIL import Image

    from sod_tpu_torch.ops import rle

    tr = os.path.join(root, "DUTS", "DUTS-TR-Image")
    os.makedirs(tr)
    rng = np.random.default_rng(8)
    masks = {}
    for i in range(n):
        b = synthetic_batch(rng, 1, size, 1)
        name = f"tr_{i:04d}.jpg"
        Image.fromarray(b["image"][0]).save(os.path.join(tr, name), quality=95)
        masks[name] = rle.encode(b["gt_masks"][0, 0])
    fp = os.path.join(root, "pseudo_masks.json")
    with open(fp, "w") as f:
        json.dump(masks, f)
    return fp


def cli_epochs(root: str, counters, **extra):
    """``python -m sod_tpu_torch.cli.train``'s ``main`` for 2 epochs on a
    64-image synthetic DUTS directory under ``root`` with the shipped config
    plus ``extra``.  ``counters``: () -> tuple of launch counts, read after
    the launch counts were set to 0 just before the run.  Returns (counts,
    steps, yaml path, settings, checkpoint dir, seconds for the dataset,
    seconds for the run)."""
    import torch
    import yaml

    from sod_tpu_torch.cli import train as cli

    t0 = time.perf_counter()
    with open(CONFIG) as f:
        settings = yaml.safe_load(f)
    pm = write_duts(root, 64, settings["train_image_size"])
    settings.update(dir_ckpt=os.path.join(root, "ckpt"), dir_dataset=root,
                    pseudo_masks_fp=pm, n_epochs=2, **extra)
    fp = os.path.join(root, "train.yaml")
    with open(fp, "w") as f:
        yaml.safe_dump(settings, f)
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    reset_launch_counts()
    cli.main(["--config", fp, "--device", "cuda"])
    torch.cuda.synchronize()
    counts = counters()
    t_run = time.perf_counter() - t0
    steps = 2 * 64 // settings["batch_size"]
    ckpt_dir = os.path.join(root, "ckpt", os.listdir(os.path.join(root, "ckpt"))[0])
    if not os.path.isfile(os.path.join(ckpt_dir, "latest_model.pt")):
        raise AssertionError("no latest_model.pt")
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "avg_loss" in r]
    if len(epochs) != 2 or not all(np.isfinite(r["avg_loss"]) for r in epochs):
        raise AssertionError(f"bad epoch records: {epochs}")
    print(f"  epoch records: " + "; ".join(
        f"epoch {r['epoch']:.0f} loss {r['avg_loss']:.4f} iou "
        f"{r['avg_iou']:.4f} step {r['step']}" for r in epochs), flush=True)
    return counts, steps, fp, settings, ckpt_dir, t_data, t_run


def trainer_check():
    """Phase 8: the CLI for 2 epochs, then --resume for a third; returns
    the K2 launch counts of the CLI's two epochs and the phase's times."""
    import torch
    import yaml

    from sod_tpu_torch.cli import train as cli
    from sod_tpu_torch.ops import flash_attention as fa

    times = {}
    with tempfile.TemporaryDirectory() as root:
        launches, steps, fp, settings, ckpt_dir, times["dataset"], times["cli 2 epochs"] = \
            cli_epochs(root, lambda: (fa.fwd_launches, fa.bwd_launches))
        depth = 12                               # ViT-S blocks
        print(f"  K2 launches over {steps} steps: forward {launches[0]}, "
              f"backward {launches[1]}", flush=True)
        if launches != (depth * steps, depth * steps):
            raise AssertionError(f"expected {depth * steps} K2 launches each way")

        t0 = time.perf_counter()
        settings["n_epochs"] = 3
        with open(fp, "w") as f:
            yaml.safe_dump(settings, f)
        cli.main(["--config", fp, "--device", "cuda", "--resume"])
        torch.cuda.synchronize()
        times["cli --resume, epoch 3"] = time.perf_counter() - t0
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
            last = [json.loads(line) for line in f if "avg_loss" in line][-1]
        if last["step"] != 3 * 64 // settings["batch_size"] or last["epoch"] != 3:
            raise AssertionError(f"resume did not continue the run: {last}")
    t0 = time.perf_counter()
    iou0, iou1, (iou_bf, iou_q, agree) = learning_check(300, 224, int8_eval=True)
    times["learning check"] = time.perf_counter() - t0
    print("  " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()), flush=True)
    if not iou1 > 0.8:
        raise AssertionError(f"learning check failed: eval IoU {iou1}")
    # scripts/learning_check.py's --int8-eval bars, on the weights trained here
    if not (iou_q > 0.8 and agree > 0.95):
        raise AssertionError(f"int8 eval: IoU {iou_q}, agreement with bf16 {agree}")
    phase(8, f"Trainer via cli.train: 2 epochs, latest_model.pt, resume; "
             f"learning check eval IoU {iou0:.3f} -> {iou1:.3f} in 300 steps; on "
             f"those weights bf16-fused IoU {iou_bf:.4f}, int8-fused IoU {iou_q:.4f}, "
             f"mask agreement {agree:.4f}")
    return launches


def learning_check(steps: int, size: int, int8_eval: bool = False, **switches):
    """scripts/learning_check.py on the port: the live model and loss, a
    synthetic saliency task (bright box on a dark ground, images in
    [0, 1]), lr 2e-5 with a steps/5 warmup and a monotone poly decay.
    ``switches``: ``Config`` fields set beside them (``use_fused_train``).
    Returns the eval IoU before and after and, with ``int8_eval`` (the
    script's ``--int8-eval``), on the trained weights: the IoU through the
    bf16 fused encoder (K1), through the int8 one (K8) and the IoU of the
    two paths' binarised masks; else None."""
    import torch

    from sod_tpu_torch.config import Config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg = Config(batch_size=8, lr=2e-5, lr_warmup_duration=1, n_epochs=10, **switches)
    mcfg = config_from(cfg)
    model = MaskFormer(mcfg)
    model.load_state_dict(random_state_dict(model, 0))
    model.cuda()
    opt = build_optimizer(cfg, model.parameters(),
                          n_iters_per_epoch=max(1, steps // 5),
                          faithful_lr_cycle=False)
    step = make_train_step(cfg, model, opt)

    def batch(rng):
        images = rng.random((8, size, size, 3)).astype(np.float32) * 0.2
        gts = np.zeros((8, 4, size, size), np.float32)
        valid = np.zeros((8, 4), bool)
        for i in range(8):
            h0, w0 = rng.integers(size // 11, size // 2, 2)
            hh, ww = rng.integers(size // 4, size // 2, 2)
            images[i, h0:h0 + hh, w0:w0 + ww] += 0.7
            gts[i, 0, h0:h0 + hh, w0:w0 + ww] = 1.0
            valid[i, 0] = True
        return _to_cuda({"image": images.clip(0, 1), "gt_masks": gts,
                         "gt_valid": valid,
                         "labels": rng.integers(0, 10000, 8).astype(np.int32)})

    def eval_iou(bt, fused=False, return_pred=False):
        with torch.no_grad():
            out = model(bt["image"].to(torch.bfloat16), fused=fused)
        best = out["objectness"][:, -1, :, 0].argmax(-1)
        pred = out["mask_pred"][:, -1][torch.arange(8), best] > 0.5   # [8, s/4, s/4]
        gt = bt["gt_masks"][:, 0, 2::4, 2::4] > 0.5
        inter = (pred & gt).sum((-1, -2)).float()
        union = (pred | gt).sum((-1, -2)).float()
        iou = float((inter / (union + 1e-7)).mean())
        return (iou, pred) if return_pred else iou

    eval_batch = batch(np.random.default_rng(999))
    iou0 = eval_iou(eval_batch)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        m = step(batch(rng))
        if i % 50 == 0:
            print(f"  learning check step {i}: loss {float(m['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    iou1 = eval_iou(eval_batch)
    if not int8_eval:
        return iou0, iou1, None
    from sod_tpu_torch.ops.fused_block_int8 import vit_quantize_int8

    before = launch_counts()
    iou_bf, m_bf = eval_iou(eval_batch, fused=True, return_pred=True)
    vit_quantize_int8(model.encoder)            # from the trained f32 weights
    iou_q, m_q = eval_iou(eval_batch, fused=True, return_pred=True)
    del model.encoder.blocks_q
    after = launch_counts()
    depth = mcfg.vit.depth
    if (after["K1"] - before["K1"], after["K8"] - before["K8"]) != (depth, depth):
        raise AssertionError("the int8 eval did not run K1 then K8 once per block")
    agree = float((m_bf & m_q).sum()) / max(float((m_bf | m_q).sum()), 1.0)
    print(f"  int8 eval on the trained weights: bf16-fused IoU {iou_bf:.4f}, int8-fused "
          f"IoU {iou_q:.4f}, mask agreement IoU {agree:.4f}", flush=True)
    return iou0, iou1, (iou_bf, iou_q, agree)


K4_FWD = {"name": "fused_ln_mlp_forward", "route": "cuda",
          "source": "sod_tpu_torch/csrc/fused_mlp.cu",
          "replaces": "sod_tpu/ops/fused_mlp.py:57"}
K5 = {"name": "fused_ln_attn_infer", "route": "cuda",
      "source": "sod_tpu_torch/csrc/fused_attn.cu",
      "replaces": "sod_tpu/ops/fused_attn.py:462"}
K6 = {"name": "fmax_tp_cnt", "route": "cuda", "source": "sod_tpu_torch/csrc/fsweep.cu",
      "replaces": "sod_tpu/ops/fsweep.py:58"}
K7 = {"name": "ub_inter_cnt", "route": "cuda", "source": "sod_tpu_torch/csrc/fused_ub.cu",
      "replaces": "sod_tpu/ops/fused_ub.py:58"}
# the eval shape: B=16 on a 400 px canvas (50 x 50 patches + CLS = 2501
# tokens), 20 queries
EVAL_B, EVAL_SIDE, EVAL_Q = 16, 400, 20


def bf16_ulp_at(ref) -> float:
    """One bf16 ulp (8 significand bits) at the largest |ref|."""
    return 2.0 ** (np.floor(np.log2(float(ref.float().abs().max()))) - 7)


def timed_pair(kern, plain, iters: int = 10):
    """(kernel ms, plain ms) per call with CUDA events, in turns on one
    card: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def eval_kernels_check(b: int = EVAL_B, side: int = EVAL_SIDE):
    """Phase 9: K5, the K4 forward, K6 and K7 against their plain versions
    at the eval shape; returns {name: (max_abs or count diff, kernel ms,
    plain ms)}."""
    import torch

    from sod_tpu_torch.ops import fsweep, fused_attn, fused_mlp, fused_ub
    from sod_tpu_torch.ops.resize import bilinear_separable

    rng = np.random.default_rng(9)
    out = {}
    g = side // 8
    n, d, h = g * g + 1, 384, 6
    n_pad = -(-n // 128) * 128
    blk = make_block(rng, d, h, True)
    x = torch.from_numpy(rng.standard_normal((b, n_pad, d), np.float32)
                         ).to(device="cuda", dtype=torch.bfloat16)
    # canvas-style key mask: each image's valid grid is a top-left rectangle
    gh = rng.integers(g // 2, g + 1, b)
    gw = rng.integers(g // 2, g + 1, b)
    gh[0] = gw[0] = g
    grid = np.arange(g)
    valid = (grid[None, :, None] < gh[:, None, None]) & (grid[None, None, :] < gw[:, None, None])
    km = np.zeros((b, n_pad), bool)
    km[:, 0] = True
    km[:, 1:n] = valid.reshape(b, -1)
    key_mask = torch.from_numpy(km).cuda()

    def check_bf16(name, got, ref):
        max_abs, rel_l2, corr = errors(got, ref)
        ulp = bf16_ulp_at(ref)
        ok = bool(torch.isfinite(got).all()) and max_abs <= ulp and corr > KERNEL_MIN_CORR
        print(f"  {name}: max_abs {max_abs:.6g} (bound: one bf16 ulp at the output's "
              f"magnitude, {ulp:.6g}) rel_l2 "
              f"{rel_l2:.6g} corr {corr:.9f} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return max_abs

    with torch.inference_mode():
        worst5 = 0.0
        for tag, mask in (("unmasked", None), ("masked", key_mask)):
            got = fused_attn.fused_ln_attn_infer(x, blk, h, n, key_mask=mask)
            torch.cuda.synchronize()
            ref = fused_attn.fused_ln_attn_infer_reference(x, blk, h, n, key_mask=mask)
            worst5 = max(worst5, check_bf16(f"K5 B={b} N={n} (pad {n_pad}) d={d} {tag}",
                                            got[:, :n], ref[:, :n]))
        times5 = timed_pair(lambda: fused_attn.fused_ln_attn_infer(x, blk, h, n, key_mask),
                            lambda: fused_attn.fused_ln_attn_infer_reference(
                                x, blk, h, n, key_mask), 5)
        out["K5"] = (worst5, *times5)

        x1 = (x.float() * 2).to(torch.bfloat16)
        got = fused_mlp.fused_ln_mlp(x1, blk)
        torch.cuda.synchronize()
        ref = fused_mlp.fused_ln_mlp_reference(x1, blk)
        worst4 = check_bf16(f"K4 forward rows={b * n_pad} d={d}", got, ref)
        out["K4"] = (worst4, *timed_pair(lambda: fused_mlp.fused_ln_mlp(x1, blk),
                                         lambda: fused_mlp.fused_ln_mlp_reference(x1, blk)))
        for t in ("K5", "K4"):
            print(f"  {t}: kernel {out[t][1]:.4f} ms, plain {out[t][2]:.4f} ms per call",
                  flush=True)

        # K6 at masks [B, 2, 400, 400]: random values, some on the thresholds
        table = fsweep.threshold_table(255, "cpu").numpy()
        sizes = np.stack([rng.integers(side // 2, side + 1, b),
                          rng.integers(side // 2, side + 1, b)], 1)
        sizes[0] = side
        masks = rng.random((b, 2, side, side), dtype=np.float32)
        on = rng.random(masks.shape) < 0.2
        masks[on] = table[rng.integers(0, 255, int(on.sum()))]
        gt = (rng.random((b, side, side)) > 0.5).astype(np.float32)
        rowv = torch.from_numpy(np.arange(side)[None] < sizes[:, :1]).cuda()
        colv = torch.from_numpy(np.arange(side)[None] < sizes[:, 1:]).cuda()
        masks_t, gt_t = torch.from_numpy(masks).cuda(), torch.from_numpy(gt).cuda()
        got = fsweep.fmax_tp_cnt(masks_t, gt_t, rowv, colv)
        torch.cuda.synchronize()
        ref = fsweep.fmax_tp_cnt_reference(masks_t, gt_t, rowv, colv)
        diff6 = sum(int((g != r).sum()) for g, r in zip(got, ref))
        print(f"  K6 masks {tuple(masks.shape)}: {diff6} of "
              f"{2 * got[0].numel()} counts differ (must be 0)", flush=True)
        if diff6:
            raise AssertionError("K6 counts differ from its plain version")
        t16 = timed_pair(lambda: fsweep.fmax_tp_cnt(masks_t, gt_t, rowv, colv),
                         lambda: fsweep.fmax_tp_cnt_reference(masks_t, gt_t, rowv, colv), 5)
        m4, g4, r4, c4 = masks_t[:4].contiguous(), gt_t[:4], rowv[:4], colv[:4]
        t4 = timed_pair(lambda: fsweep.fmax_tp_cnt(m4, g4, r4, c4),
                        lambda: fsweep.fmax_tp_cnt_reference(m4, g4, r4, c4), 5)
        print(f"  K6 B=16: kernel {t16[0]:.4f} ms, plain {t16[1]:.4f} ms; B=4: kernel "
              f"{t4[0]:.4f} ms, plain {t4[1]:.4f} ms per call", flush=True)
        out["K6"] = (diff6, *t16)

        # K7 at [B, 20, 100, 100] -> 400 px; sigmoid-like values around 0.5
        low = torch.from_numpy(1 / (1 + np.exp(-3 * rng.standard_normal(
            (b, EVAL_Q, side // 4, side // 4))).astype(np.float32))).cuda()
        got = fused_ub.ub_inter_cnt(low, gt_t, rowv, colv)
        torch.cuda.synchronize()
        ref = fused_ub.ub_inter_cnt_reference(low, gt_t, rowv, colv)
        near = torch.stack([((bilinear_separable(low[:, q], side, side) - 0.5).abs() <= 1e-6)
                            .logical_and(rowv[:, :, None] & colv[:, None, :]).sum((1, 2))
                            for q in range(EVAL_Q)], 1).float()
        diff7 = [(g - r).abs() for g, r in zip(got, ref)]
        n_diff = int(sum(int((dd > 0).sum()) for dd in diff7))
        ok = all(bool((dd <= near).all()) for dd in diff7)
        print(f"  K7 low {tuple(low.shape)} -> {side} px: {n_diff} of "
              f"{2 * got[0].numel()} counts differ, by at most {float(max(dd.max() for dd in diff7)):.0f}; "
              f"{int(near.sum())} plain upsampled values within 1e-6 of 0.5 "
              f"(the bound) -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("K7 counts differ beyond the near-0.5 pixels")
        t7 = timed_pair(lambda: fused_ub.ub_inter_cnt(low, gt_t, rowv, colv),
                        lambda: fused_ub.ub_inter_cnt_reference(low, gt_t, rowv, colv), 5)
        print(f"  K7 B=16: kernel {t7[0]:.4f} ms, plain {t7[1]:.4f} ms per call", flush=True)
        out["K7"] = (float(max(dd.max() for dd in diff7)), *t7)
    # bounds from this run's data: real tokens, each image's valid keys, the
    # valid rectangles of the masks
    hidden = blk.mlp.fc1.weight.shape[0]
    c = block_cost(b * n, b, n, d, hidden)
    act = 2 * b * n * d                                   # one bf16 [B, n, d] slab
    valid_px = float((sizes[:, 0] * sizes[:, 1]).sum())
    out["bound"] = {
        "K5": roofline(c["qkv"] + c["proj"] + 2 * 2 * n * d * float(km.sum()),
                       2 * act + c["w_attn"] + km.size),
        "K4": roofline(2 * c["fc"], 2 * act + c["w_mlp"]),
        "K6": roofline(2 * 2 * valid_px, 4 * 3 * valid_px + 8 * 2 * b * 2 * 255,
                       PEAK_F32_FLOPS),
        "K7": roofline(10 * EVAL_Q * valid_px, 4 * low.numel() + 4 * valid_px
                       + 8 * 2 * b * EVAL_Q, PEAK_F32_FLOPS)}
    phase(9, "K5 and the K4 forward within one bf16 ulp of their plain versions, "
             "K6 exact, K7 within the near-0.5 bound, at the eval shape")
    return out



def write_duts_te(root: str, n: int, lo: int, hi: int, seed: int) -> None:
    """A synthetic DUTS-TE split under ``root/DUTS``: JPEG images (a bright
    box on a dark noisy ground) and PNG GT masks with sides in [lo, hi];
    the first image is hi x hi, so the canvas is hi px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    te, gtd = (os.path.join(root, "DUTS", d) for d in ("DUTS-TE-Image", "DUTS-TE-Mask"))
    os.makedirs(te)
    os.makedirs(gtd)
    for i in range(n):
        h, w = (hi, hi) if i == 0 else rng.integers(lo, hi + 1, 2)
        img = (rng.random((h, w, 3)) * 60).astype(np.uint8)
        y0, x0 = rng.integers(0, h // 3), rng.integers(0, w // 3)
        y1, x1 = y0 + rng.integers(h // 4, h // 2), x0 + rng.integers(w // 4, w // 2)
        img[y0:y1, x0:x1] += 150
        gt = np.zeros((h, w), np.uint8)
        gt[y0:y1, x0:x1] = 255
        Image.fromarray(img).save(os.path.join(te, f"te_{i:03d}.jpg"), quality=95)
        Image.fromarray(gt).save(os.path.join(gtd, f"te_{i:03d}.png"))


@contextlib.contextmanager
def plain_eval_kernels():
    """Every kernel of the evaluation path replaced by its plain version on
    CUDA tensors (the kernels' twin for phase 10)."""
    from sod_tpu_torch.metrics import batched
    from sod_tpu_torch.models import vit
    from sod_tpu_torch.ops import fsweep, fused_attn, fused_block, fused_mlp, fused_ub

    swaps = [(vit, "fused_vit_block", fused_block.fused_vit_block_reference),
             (vit, "fused_ln_attn_infer", fused_attn.fused_ln_attn_infer_reference),
             (vit, "fused_ln_mlp", fused_mlp.fused_ln_mlp_reference),
             (batched, "fmax_tp_cnt", fsweep.fmax_tp_cnt_reference),
             (batched, "ub_inter_cnt", fused_ub.ub_inter_cnt_reference)]
    kept = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    with _PlainFlash():
        for m, name, fn in swaps:
            setattr(m, name, fn)
        try:
            yield
        finally:
            for m, name, fn in kept:
                setattr(m, name, fn)


def launch_counts() -> dict:
    from sod_tpu_torch.ops import flash_attention as fa
    from sod_tpu_torch.ops import (fsweep, fused_attn, fused_block, fused_block_int8,
                                   fused_mlp, fused_ub)

    return {"K1": fused_block.launches, "K8": fused_block_int8.launches,
            "K2 fwd": fa.fwd_launches,
            "K2 bwd": fa.bwd_launches, "K3 fwd": fused_attn.train_fwd_launches,
            "K3 bwd": fused_attn.train_bwd_launches,
            "K5": fused_attn.launches, "K4 fwd": fused_mlp.launches,
            "K4 bwd": fused_mlp.bwd_launches,
            "K6": fsweep.launches, "K7": fused_ub.launches}


def reset_launch_counts() -> None:
    from sod_tpu_torch.ops import flash_attention as fa
    from sod_tpu_torch.ops import (fsweep, fused_attn, fused_block, fused_block_int8,
                                   fused_mlp, fused_ub)

    fused_block.launches = fused_block_int8.launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    fused_attn.launches = fused_mlp.launches = fsweep.launches = fused_ub.launches = 0
    fused_attn.train_fwd_launches = fused_attn.train_bwd_launches = 0
    fused_mlp.bwd_launches = 0


# Evaluator through the kernels vs through the plain versions, same weights
# and images: single bf16 roundings that differ flip through 12 blocks, so
# masks agree to a few 1e-2 at a few pixels (phase 4's served-mask bounds:
# max 0.3, mean 0.01) and a near-tie of objectness can pick another query
# for an image, which moves a mean over 32 images by up to 1/32
EVAL_TOKENS_REL_L2, EVAL_MASK_MAX, EVAL_MASK_MEAN, EVAL_METRIC_TOL = 0.02, 0.3, 0.01, 0.05


def evaluator_check(n_images: int = 32, side: int = EVAL_SIDE, small_side: int = 224,
                    b: int = EVAL_B):
    """Phase 10: the Evaluator on the card, both paths, kernels and plain;
    the evaluate CLI; one Trainer epoch with its evaluation.  Returns the
    launch counts of the main runs: {path: counts}."""
    import torch
    import yaml

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.cli import evaluate as evaluate_cli
    from sod_tpu_torch.cli import train as train_cli
    from sod_tpu_torch.data.factory import get_dataset
    from sod_tpu_torch.models.maskformer import (MaskFormer, config_from,
                                                 maskformer_apply_canvas, random_state_dict)
    from sod_tpu_torch.models.vit import vit_apply
    from sod_tpu_torch.train.evaluator import Evaluator, canvas_inputs, collate_canvas

    all_counts = {}
    with tempfile.TemporaryDirectory() as root:
        big, small = os.path.join(root, "big"), os.path.join(root, "small")
        write_duts_te(big, n_images, side // 2, side, 10)
        write_duts_te(small, b, small_side * 2 // 3, small_side, 11)
        cfg = load_config(CONFIG, {"dir_dataset": big})
        mcfg = config_from(cfg)
        model = MaskFormer(mcfg)
        model.load_state_dict(random_state_dict(model, cfg.seed))
        model.cuda()
        depth = mcfg.vit.depth

        # one batch: encoder tokens and low-res masks, kernels vs plain
        ds = get_dataset(big, "duts", "test")
        ds.return_raw = True
        batch = collate_canvas([ds[i] for i in range(b)], b, (side, side),
                               mcfg.vit.patch_size)
        grids = torch.from_numpy(batch["grid_sizes"]).cuda()
        image, tok, pe = canvas_inputs(model, torch.from_numpy(batch["image"]).cuda(),
                                       grids, torch.bfloat16)
        with torch.inference_mode():
            for fused in (False, True):
                outs = []
                for plain in (False, True):
                    with (plain_eval_kernels() if plain else contextlib.nullcontext()):
                        enc = vit_apply(model.encoder, image, fused=fused, token_mask=tok,
                                        pos_embed_override=pe)
                        low = maskformer_apply_canvas(model, image, tok, pe, grids,
                                                      fused=fused)["mask_pred"][:, -1]
                    outs.append((enc, low))
                (ek, lk), (ep, lp) = outs
                rel = float((ek.float() - ep.float()).norm() / ep.float().norm())
                gap = (lk - lp).abs()
                ok = (rel <= EVAL_TOKENS_REL_L2 and float(gap.max()) <= EVAL_MASK_MAX
                      and float(gap.mean()) <= EVAL_MASK_MEAN and bool(torch.isfinite(lk).all()))
                print(f"  {'use_fused_eval' if fused else 'default'} path, one B={b} batch "
                      f"at {side} px: encoder tokens rel L2 {rel:.6g}, low-res masks "
                      f"{tuple(lk.shape)} max_abs {float(gap.max()):.6g} mean_abs "
                      f"{float(gap.mean()):.6g}, kernels vs plain -> {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError("the eval forward disagrees with its plain version")

        n_batches = -(-n_images // b)
        expected = {"default": {"K2 fwd": depth, "K6": 1},
                    "use_fused_eval": {"K5": depth, "K4 fwd": depth, "K7": 1, "K6": 1}}
        timings = {}
        for path, exp in expected.items():
            pcfg = load_config(CONFIG, {"dir_dataset": big,
                                        "use_fused_eval": path == "use_fused_eval"})
            ev = Evaluator(model, pcfg, mcfg, batch_size=b, device="cuda")
            ev("duts")                                       # warm-up
            res, secs = {}, {}
            for mode in ("kernels", "plain"):
                with (plain_eval_kernels() if mode == "plain" else contextlib.nullcontext()):
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    res[mode] = ev("duts", dir_ckpt=os.path.join(root, "eval", path, mode))
                    torch.cuda.synchronize()
                    secs[mode] = time.perf_counter() - t0
                    counts = launch_counts()
                want = ({k: v * n_batches for k, v in exp.items()} if mode == "kernels" else {})
                got = {k: v for k, v in counts.items() if v}
                print(f"  {path}, {mode}: launches {got} over {n_batches} batches "
                      f"(expected {want}); {n_images / secs[mode]:.1f} img/s "
                      f"({secs[mode] * 1e3:.1f} ms for {n_images} images)", flush=True)
                if got != want:
                    raise AssertionError(f"{path} ({mode}): launch counts {got}, expected {want}")
                if mode == "kernels":
                    all_counts[path] = counts
            for k, got_v in res["kernels"].items():
                plain_v = res["plain"][k]
                print(f"    {k:18s} kernels {got_v:.6f}  plain {plain_v:.6f}")
                if not (np.isfinite(got_v) and abs(got_v - plain_v) <= EVAL_METRIC_TOL):
                    raise AssertionError(f"{path}: {k} {got_v} vs plain {plain_v}")
            timings[path] = (n_images / secs["kernels"], n_images / secs["plain"])
            profile_steps(lambda _: ev("duts"), None, 1, secs["kernels"] * 1e3,
                          unit="eval call")

        # the 224 px canvas: 785 tokens -> n_pad 896, the masked K1 route
        scfg = load_config(CONFIG, {"dir_dataset": small, "use_fused_eval": True})
        ev = Evaluator(model, scfg, mcfg, batch_size=b, device="cuda")
        reset_launch_counts()
        res = ev("duts")
        counts = {k: v for k, v in launch_counts().items() if v}
        print(f"  use_fused_eval on a {small_side} px canvas ({b} images): launches {counts}; "
              f"iou {res['iou']:.4f}, iou_ub {res['iou_ub']:.4f}", flush=True)
        if counts != {"K1": depth, "K7": 1, "K6": 1}:
            raise AssertionError(f"224 px fused eval launched {counts}")
        all_counts[f"use_fused_eval {small_side} px"] = launch_counts()

        # the CLI once on the 400 px directory
        with open(CONFIG) as f:
            settings = yaml.safe_load(f)
        settings.update(dir_dataset=big)
        fp = os.path.join(root, "eval.yaml")
        with open(fp, "w") as f:
            yaml.safe_dump(settings, f)
        t0 = time.perf_counter()
        metrics = evaluate_cli.main(["--config", fp, "--dataset_name", "duts",
                                     "--device", "cuda", "--dir_root", root])
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the evaluate CLI returned {metrics}")
        print(f"  evaluate CLI: {len(metrics)} metrics in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # one Trainer epoch whose evaluation keeps best_model_duts
        pm = write_duts(big, 16, settings["train_image_size"])
        settings.update(dir_ckpt=os.path.join(root, "ckpt"), pseudo_masks_fp=pm, n_epochs=1)
        with open(fp, "w") as f:
            yaml.safe_dump(settings, f)
        t0 = time.perf_counter()
        train_cli.main(["--config", fp, "--device", "cuda"])
        ckpt_dir = os.path.join(root, "ckpt", os.listdir(os.path.join(root, "ckpt"))[0])
        with open(os.path.join(ckpt_dir, "best_scores.json")) as f:
            best = json.load(f)
        if not os.path.isfile(os.path.join(ckpt_dir, "best_model_duts.pt")) or "duts" not in best:
            raise AssertionError("the Trainer's evaluation kept no best_model_duts")
        print(f"  Trainer epoch + evaluation: best_model_duts.pt, best_scores {best}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase(10, f"Evaluator on the card: default {timings['default'][0]:.1f} img/s "
              f"(plain {timings['default'][1]:.1f}), use_fused_eval "
              f"{timings['use_fused_eval'][0]:.1f} img/s (plain "
              f"{timings['use_fused_eval'][1]:.1f}); CLI and Trainer evaluation ran")
    return all_counts


K3_FWD = {"name": "fused_ln_attn_forward", "route": "cuda",
          "source": "sod_tpu_torch/csrc/fused_attn.cu",
          "replaces": "sod_tpu/ops/fused_attn.py:58"}
K3_BWD = dict(K3_FWD, name="fused_ln_attn_backward",
              replaces="sod_tpu/ops/fused_attn.py:182")
K4_SAVE = dict(K4_FWD, name="fused_ln_mlp_forward_save",
               replaces="sod_tpu/ops/fused_mlp.py:68")
K4_BWD = dict(K4_FWD, name="fused_ln_mlp_backward",
              replaces="sod_tpu/ops/fused_mlp.py:122")
# f32 gradient sums of the backward kernels against their plain versions:
# products of bf16 values summed over 6280 rows in another order (first H100
# run: rel L2 <= 3.1e-4, corr >= 0.99999995)
GRAD_MAX_REL_L2, GRAD_MIN_CORR = 1e-2, 0.9999
TRAIN_B, TRAIN_N = 8, 785


def fused_train_kernels_check(b: int = TRAIN_B, n_real: int = TRAIN_N):
    """Phase 11: K3 and K4's training kernels against their plain versions
    at the train shape; returns {name: (worst max_abs, kernel ms, plain ms)}
    and their bounds."""
    import torch

    from sod_tpu_torch.ops import fused_attn as fattn
    from sod_tpu_torch.ops import fused_mlp as fmlp

    rng = np.random.default_rng(11)
    d, h, eps = 384, 6, 1e-6
    n_pad = -(-n_real // 128) * 128
    blk = make_block(rng, d, h, True)
    hidden = blk.mlp.fc1.weight.shape[0]

    def tokens(scale, shape=(b, n_pad, d), real=n_real):
        a = rng.standard_normal(shape, np.float32) * scale
        a[:, real:] = 0                        # the entry pads with zeros
        return torch.from_numpy(a).to(device="cuda", dtype=torch.bfloat16)

    x, g = tokens(1.0), tokens(0.5)
    worst = {}

    def check(kind, name, got, ref, bf16_out):
        max_abs, rel_l2, corr = errors(got, ref)
        if bf16_out:
            # one rounding flip of the output on top of one of a bf16 input of
            # the last product (first H100 runs: at most one ulp)
            bound = 2 * bf16_ulp_at(ref)
            ok = max_abs <= bound and corr > KERNEL_MIN_CORR
            how = f"max_abs {max_abs:.6g} (bound: two bf16 ulps, {bound:.6g})"
        else:
            ok = rel_l2 <= GRAD_MAX_REL_L2 and corr > GRAD_MIN_CORR
            how = f"max_abs {max_abs:.6g}"
        ok = ok and bool(torch.isfinite(got).all())
        print(f"  {name}: {how} rel_l2 {rel_l2:.6g} corr {corr:.9f} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        worst[kind] = max(worst.get(kind, 0.0), max_abs)

    with torch.no_grad():
        # ---- K3
        w3 = [w.detach() for w in fattn._weights(blk)]
        out, qkv, attn, m, l = fattn.train_forward_cuda(x, w3, h, n_real, eps)
        torch.cuda.synchronize()
        ref_out, _, ref_qkv, ref_attn = fattn._forward_plain(x, w3, h, n_real, None, eps)
        tag = f"K3 B={b} N={n_real} (pad {n_pad}) d={d}"
        check("K3 fwd", f"{tag} forward out", out[:, :n_real], ref_out[:, :n_real], True)
        check("K3 fwd", f"{tag} forward qkv (kept under save_acts)", qkv, ref_qkv, True)
        check("K3 fwd", f"{tag} forward attn (kept under save_attn)", attn, ref_attn, True)
        names3 = ("dx", "dLN scale", "dLN bias", "dWqkv", "dbqkv", "dWproj", "dbproj")
        ref3 = fattn.fused_ln_attn_backward_reference(x, g, w3, h, n_real, eps)
        by_mode = {}
        for mode, kw in (("nothing kept", {}), ("qkv kept", {"qkv_saved": qkv}),
                         ("attn kept", {"attn_saved": attn})):
            got3 = fattn.train_backward_cuda(x, g, w3, h, n_real, eps, m, l, **kw)
            torch.cuda.synchronize()
            for nm, a, r in zip(names3, got3, ref3):
                a, r = (a[:, :n_real], r[:, :n_real]) if nm == "dx" else (a, r)
                check("K3 bwd", f"{tag} backward, {mode}: {nm}", a, r, nm == "dx")
            by_mode[mode] = [t.clone() for t in got3]
        again = fattn.train_backward_cuda(x, g, w3, h, n_real, eps, m, l, attn_saved=attn)
        torch.cuda.synchronize()
        same_run = all(torch.equal(a, c) for a, c in zip(again, by_mode["attn kept"]))
        same_modes = all(torch.equal(a, c) for mode in ("qkv kept", "attn kept")
                         for a, c in zip(by_mode[mode], by_mode["nothing kept"]))
        print(f"  K3 backward: two runs bit for bit: {same_run}; the three save modes "
              f"bit for bit: {same_modes} (the recompute is the forward's arithmetic)",
              flush=True)
        if not (same_run and same_modes):
            raise AssertionError("K3 backward differs between runs or save modes")

        # ---- K4
        w4 = [w.detach() for w in fmlp._weights(blk)]
        # the rows the model hands it: 8 x 785 = 6280, padded to the 64-row tile
        # (6336: twelve 512-row splits of the weight gradients and a ragged one)
        rows_real = b * n_real
        rows = -(-rows_real // fmlp.ROWS) * fmlp.ROWS
        x2 = tokens(2.0, (1, rows, d), rows_real)[0]
        g2 = tokens(0.5, (1, rows, d), rows_real)[0]
        out4, a4 = fmlp.forward_cuda(x2, w4, eps, True)
        out4_plain_fwd, _ = fmlp.forward_cuda(x2, w4, eps, False)
        torch.cuda.synchronize()
        ref_out4, ref_a = fmlp._forward_plain(x2, w4, eps)
        tag = f"K4 rows={rows_real} (pad {rows}) d={d} hidden={hidden}"
        check("K4 save", f"{tag} save forward out", out4, ref_out4, True)
        check("K4 save", f"{tag} save forward hidden a", a4, ref_a.to(torch.bfloat16), True)
        if not torch.equal(out4, out4_plain_fwd):
            raise AssertionError("K4's save forward and plain forward outputs differ")
        names4 = ("dx", "dLN scale", "dLN bias", "dW1", "db1", "dW2", "db2")
        got_by = {}
        for mode, a_saved in (("recompute", None), ("hidden kept", a4)):
            got4 = fmlp.backward_cuda(x2, g2, w4, eps, a_saved)
            torch.cuda.synchronize()
            ref4 = fmlp.fused_ln_mlp_backward_reference(x2, g2, w4, eps, a_saved)
            for nm, a, r in zip(names4, got4, ref4):
                check("K4 bwd", f"{tag} backward, {mode}: {nm}", a, r, nm == "dx")
            got_by[mode] = [t.clone() for t in got4]
        gaps = [errors(a, c)[1] for a, c in zip(got_by["hidden kept"][1:],
                                                got_by["recompute"][1:])]
        print(f"  K4 backward, hidden kept vs recompute (gelu' on the bf16 a vs the f32 a): "
              f"rel_l2 of the six gradients <= {max(gaps):.6g} (bound {GRAD_MAX_REL_L2})",
              flush=True)
        if not max(gaps) <= GRAD_MAX_REL_L2:
            raise AssertionError("K4's two backward variants disagree")
        again = fmlp.backward_cuda(x2, g2, w4, eps, None)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(again, got_by["recompute"])):
            raise AssertionError("K4 backward differs between two runs")
        print("  K4 backward: two runs bit for bit: True", flush=True)

        # ---- the other head widths the kernels are built for (32, 128), small;
        # K4 on 576 rows: a full 512-row split of the weight gradients and a
        # ragged one
        for dd, hh in ((128, 4), (256, 2)):
            blk_s = make_block(rng, dd, hh, True)
            ws = [w.detach() for w in fattn._weights(blk_s)]
            xs, gs = tokens(1.0, (2, 128, dd), 100), tokens(0.5, (2, 128, dd), 100)
            out_s, _, _, m_s, l_s = fattn.train_forward_cuda(xs, ws, hh, 100, eps)
            got_s = fattn.train_backward_cuda(xs, gs, ws, hh, 100, eps, m_s, l_s)
            torch.cuda.synchronize()
            tag = f"K3 head dim {dd // hh} (d {dd}, 100 of 128 tokens)"
            check("small", f"{tag} forward out", out_s,
                  fattn._forward_plain(xs, ws, hh, 100, None, eps)[0], True)
            for nm, a, r in zip(names3, got_s, fattn.fused_ln_attn_backward_reference(
                    xs, gs, ws, hh, 100, eps)):
                check("small", f"{tag} backward: {nm}", a, r, nm == "dx")
            w4s = [w.detach() for w in fmlp._weights(blk_s)]
            x4s = tokens(2.0, (1, 576, dd), 576)[0]
            g4s = tokens(0.5, (1, 576, dd), 576)[0]
            got_s = fmlp.backward_cuda(x4s, g4s, w4s, eps, None)
            torch.cuda.synchronize()
            for nm, a, r in zip(names4, got_s, fmlp.fused_ln_mlp_backward_reference(
                    x4s, g4s, w4s, eps, None)):
                check("small", f"K4 rows=576 d={dd} backward: {nm}", a, r, nm == "dx")

    # ---- the entries the model calls, at the main path's shape: bf16 tokens
    # [8, 785, 384], f32 master weights.  Against the same call with the kernel
    # chains swapped for their plain versions: the padding to 896 tokens (K3)
    # and 6336 rows (K4) and the slicing back, the zero-filled gradient of the
    # padded rows, the weight casts, K4's bf16 rounding of its weight
    # gradients, (out, in) layouts and parameter dtypes
    def entry_check(tag, fn, params, names, x_in, g_in):
        def run():
            for p in params:
                p.grad = None
            xin = x_in.clone().requires_grad_()
            y = fn(xin)
            y.backward(g_in)
            torch.cuda.synchronize()
            return [y.detach(), xin.grad, *(p.grad.clone() for p in params)]

        before = sum(launch_counts().values())
        got = run()
        if sum(launch_counts().values()) - before != 2:
            raise AssertionError(f"{tag}: expected one forward and one backward launch")
        with plain_fused_train():
            ref = run()
        for nm, a, r, p in zip(("out", *names), got, ref, [x_in, x_in, *params]):
            if a.shape != r.shape or a.shape != p.shape or a.dtype != p.dtype:
                raise AssertionError(f"{tag} {nm}: {tuple(a.shape)} {a.dtype} for a "
                                     f"{tuple(p.shape)} {p.dtype} tensor")
            check("entry", f"{tag}: {nm}", a, r, nm in ("out", "dx"))

    blk32 = make_block(rng, d, h, True).float()           # f32 master weights
    xe, ge = tokens(1.0, (b, n_real, d)), tokens(0.5, (b, n_real, d))
    tag = f"fused_ln_attn [{b}, {n_real}, {d}] bf16, f32 weights"
    for mode, kw in (("attn kept", {"save_attn": True}), ("qkv kept", {"save_acts": True}),
                     ("nothing kept", {})):
        entry_check(f"{tag}, {mode}",
                    lambda t, kw=kw: fattn.fused_ln_attn(t, blk32, h, eps, **kw),
                    fattn._weights(blk32), names3, xe, ge)
    tag = f"fused_ln_mlp [{b}, {n_real}, {d}] bf16, f32 weights"
    for mode, keep in (("recompute", False), ("hidden kept", True)):
        entry_check(f"{tag}, {mode}",
                    lambda t, keep=keep: fmlp.fused_ln_mlp(t, blk32, eps, save_acts=keep),
                    fmlp._weights(blk32), names4, xe * 2, ge)
    # K3 beyond 1536 padded tokens (the cap of the TPU's kernels, not of these):
    # 1601 tokens padded to 1664, forward and backward
    n_long = 1601
    xl, gl = tokens(1.0, (2, n_long, d), n_long), tokens(0.5, (2, n_long, d), n_long)
    for mode, kw in (("attn kept", {"save_attn": True}), ("nothing kept", {})):
        entry_check(f"fused_ln_attn [2, {n_long}, {d}] (pad 1664), {mode}",
                    lambda t, kw=kw: fattn.fused_ln_attn(t, blk32, h, eps, **kw),
                    fattn._weights(blk32), names3, xl, gl)

    with torch.no_grad():
        # ---- times, in turns with the plain versions
        pairs = {
            "K3 fwd": (lambda: fattn.train_forward_cuda(x, w3, h, n_real, eps),
                       lambda: fattn._forward_plain(x, w3, h, n_real, None, eps)),
            "K3 bwd": (lambda: fattn.train_backward_cuda(x, g, w3, h, n_real, eps, m, l,
                                                         attn_saved=attn),
                       lambda: fattn.fused_ln_attn_backward_reference(
                           x, g, w3, h, n_real, eps, attn_saved=attn)),
            "K3 bwd, qkv kept": (
                lambda: fattn.train_backward_cuda(x, g, w3, h, n_real, eps, m, l,
                                                  qkv_saved=qkv), None),
            "K3 bwd, nothing kept": (
                lambda: fattn.train_backward_cuda(x, g, w3, h, n_real, eps, m, l), None),
            "K4 save": (lambda: fmlp.forward_cuda(x2, w4, eps, True),
                        lambda: fmlp._forward_plain(x2, w4, eps)),
            "K4 bwd": (lambda: fmlp.backward_cuda(x2, g2, w4, eps, None),
                       lambda: fmlp.fused_ln_mlp_backward_reference(x2, g2, w4, eps, None)),
            "K4 bwd, hidden kept": (lambda: fmlp.backward_cuda(x2, g2, w4, eps, a4), None)}
        out = {}
        for name, (kern, plain) in pairs.items():
            if plain is None:
                print(f"  {name}: kernel {cuda_ms(kern, 10):.4f} ms per call", flush=True)
                continue
            t = timed_pair(kern, plain, 10)
            out[name] = (worst[name], *t)
            print(f"  {name}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms per call", flush=True)

    c = block_cost(b * n_real, b, n_real, d, hidden)
    act = 2 * b * n_real * d
    out["bound"] = {
        # the main path's variants: K3 keeps attn, K4 recomputes
        "K3 fwd": roofline(c["qkv"] + 2 * c["scores"] + c["proj"], 3 * act + c["w_attn"]),
        "K3 bwd": roofline(3 * c["qkv"] + 2 * c["proj"] + 5 * c["scores"],
                           4 * act + 3 * c["w_attn"]),
        "K4 save": roofline(2 * c["fc"], 2 * act + 2 * b * n_real * hidden + c["w_mlp"]),
        "K4 bwd": roofline(5 * c["fc"], 3 * act + 3 * c["w_mlp"])}
    phase(11, f"K3 (forward, backward in three save modes) and K4 (save forward, both "
              f"backward variants) match their plain versions: bf16 outputs within two "
              f"ulps, f32 gradients rel_l2 <= {GRAD_MAX_REL_L2}")
    return out


@contextlib.contextmanager
def plain_fused_train():
    """K3's and K4's kernel chains replaced by their plain versions on CUDA
    tensors, under the same autograd Functions (the kernels' twin for phase
    12); with K2's plain versions for the ``use_fused_mlp`` step."""
    import torch

    from sod_tpu_torch.ops import fused_attn as fattn
    from sod_tpu_torch.ops import fused_mlp as fmlp

    def attn_fwd(x, weights, n_heads, n_real, eps):
        out, _, qkv, attn = fattn._forward_plain(x, weights, n_heads, n_real, None, eps)
        none = torch.empty(0, device=x.device)
        return out, qkv.to(torch.bfloat16), attn.to(torch.bfloat16), none, none

    def attn_bwd(x, g, weights, n_heads, n_real, eps, m, l, **saved):
        return fattn.fused_ln_attn_backward_reference(x, g, weights, n_heads, n_real,
                                                      eps, **saved)

    def mlp_fwd(x2d, weights, eps, want_hidden):
        out, a = fmlp._forward_plain(x2d, weights, eps)
        return out, (a.to(torch.bfloat16) if want_hidden else None)

    def mlp_bwd(x2d, dy, weights, eps, a_saved=None):
        return fmlp.fused_ln_mlp_backward_reference(x2d, dy, weights, eps, a_saved)

    swaps = [(fattn, "train_forward_cuda", attn_fwd), (fattn, "train_backward_cuda", attn_bwd),
             (fmlp, "forward_cuda", mlp_fwd), (fmlp, "backward_cuda", mlp_bwd)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    with _PlainFlash():
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in kept:
                setattr(mod, name, fn)


def fused_train_step_check():
    """Phase 12: returns the launch counts of one step per switch, the step
    times and the profile of the ``use_fused_train`` step."""
    import torch

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.ops import fused_mlp as fmlp
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    base = load_config(CONFIG)
    depth = config_from(base).vit.depth
    batch = _to_cuda(synthetic_batch(np.random.default_rng(12), base.batch_size,
                                     base.train_image_size, base.max_gt_masks))

    def build(**switches):
        cfg = base.replace(**switches)
        mcfg = config_from(cfg)
        model = MaskFormer(mcfg)
        model.load_state_dict(random_state_dict(model, cfg.seed))
        model.cuda()
        opt = build_optimizer(cfg, model.parameters(), n_iters_per_epoch=100)
        return model, make_train_step(cfg, model, opt)

    def one_step(step):
        reset_launch_counts()
        fmlp.save_launches = 0
        metrics = step(batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        return {k: float(v) for k, v in metrics.items()}, counts

    expected = {
        "use_fused_train": {"K3 fwd": depth, "K3 bwd": depth, "K4 fwd": depth, "K4 bwd": depth},
        "use_fused_mlp": {"K2 fwd": depth, "K2 bwd": depth, "K4 fwd": depth, "K4 bwd": depth}}
    all_counts = {}
    for switch, want in expected.items():
        model_k, step_k = build(**{switch: True})
        model_p, step_p = build(**{switch: True})
        before = {k: v.detach().clone() for k, v in model_k.state_dict().items()}
        mk, counts = one_step(step_k)
        with plain_fused_train():
            mp, counts_p = one_step(step_p)
        print(f"  {switch}: launches in one step {counts} (expected {want}); through the "
              f"plain versions {counts_p}", flush=True)
        if counts != want or counts_p:
            raise AssertionError(f"{switch}: launch counts {counts} / plain {counts_p}")
        print("    kernel step: " + ", ".join(f"{k} {v:.6g}" for k, v in mk.items()))
        print("    plain step:  " + ", ".join(f"{k} {v:.6g}" for k, v in mp.items()))
        if not all(np.isfinite(list(mk.values()))):
            raise AssertionError("non-finite train metrics")
        upd = [torch.cat([(v - before[k]).flatten() for k, v in mdl.state_dict().items()])
               for mdl in (model_k, model_p)]
        corr = float(np.corrcoef(upd[0].cpu().numpy(), upd[1].cpu().numpy())[0, 1])
        loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
        gnorm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / abs(mp["grad_norm"])
        print(f"    kernel vs plain: loss rel {loss_rel:.3g}, grad_norm rel {gnorm_rel:.3g}, "
              f"update corr {corr:.6f}", flush=True)
        if not (loss_rel <= STEP_LOSS_RTOL and gnorm_rel <= STEP_GNORM_RTOL
                and corr > STEP_MIN_UPDATE_CORR):
            raise AssertionError(f"the {switch} kernel step disagrees with the plain step")
        all_counts[switch] = counts

    # the other save modes stay reachable: one step each from the same weights
    first_loss, peak_mib = {}, {}
    for tag, switches, env in (("attn kept (default)", {}, None),
                               ("fused_save_acts", {"fused_save_acts": True}, None),
                               ("SOD_NO_SAVE_ATTN", {}, "1")):
        if env:
            os.environ["SOD_NO_SAVE_ATTN"] = env
        try:
            _, step = build(use_fused_train=True, **switches)
            m, counts = one_step(step)
            kept_hidden = fmlp.save_launches
            # what a step holds at its peak on top of the model and the
            # optimizer state (which the first step allocated)
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one_step(step)
            peak_mib[tag] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        finally:
            os.environ.pop("SOD_NO_SAVE_ATTN", None)
        del step
        first_loss[tag] = m["loss"]
        print(f"  use_fused_train, {tag}: loss {m['loss']:.6g} grad_norm "
              f"{m['grad_norm']:.6g}, launches {counts}, of them K4 forwards that keep "
              f"the hidden: {kept_hidden}; peak device memory of a step above the "
              f"weights and optimizer state {peak_mib[tag]:.1f} MiB", flush=True)
        if counts != expected["use_fused_train"]:
            raise AssertionError(f"{tag}: launch counts {counts}")
        if kept_hidden != (depth if switches else 0):
            raise AssertionError(f"{tag}: {kept_hidden} launches of K4's save forward")
        all_counts[tag] = dict(counts, **{"K4 save": kept_hidden})
    ref = first_loss["attn kept (default)"]
    if not all(abs(v - ref) <= STEP_LOSS_RTOL * abs(ref) for v in first_loss.values()):
        raise AssertionError(f"the save modes' first losses differ: {first_loss}")

    # the three paths side by side, on fresh models with everything above freed
    # (the plain steps leave the allocator's pool and the collector's lists large)
    del model_k, model_p, step_k, step_p, before, upd
    gc.collect()
    torch.cuda.empty_cache()
    steps = {"use_fused_train": build(use_fused_train=True)[1],
             "use_fused_mlp": build(use_fused_mlp=True)[1],
             "default (K2)": build()[1]}

    def step_ms(step, n=10):
        step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    # in turns on one card, twice round
    rounds = [{name: step_ms(step) for name, step in steps.items()} for _ in range(2)]
    times = {name: (rounds[0][name] + rounds[1][name]) / 2 for name in steps}
    b = base.batch_size
    print(f"  step at B={b}, two rounds of 10 steps in turns: " + "; ".join(
        f"{name} {rounds[0][name]:.3f} and {rounds[1][name]:.3f} ms "
        f"({b * 1e3 / t:.1f} img/s)" for name, t in times.items()), flush=True)
    prof = profile_steps(steps["use_fused_train"], batch, 3, times["use_fused_train"])
    phase(12, f"fused train step at full width: {depth}+{depth} launches of K3 and of K4 "
              f"(use_fused_mlp: of K2 and of K4), agrees with the plain step, "
              f"{times['use_fused_train']:.1f} ms/step (use_fused_mlp "
              f"{times['use_fused_mlp']:.1f}, default {times['default (K2)']:.1f})")
    return all_counts, times, prof


def fused_trainer_check():
    """Phase 13: the CLI with ``use_fused_train`` for 2 epochs, then the
    learning check through the fused path; returns the CLI's launch counts."""
    with tempfile.TemporaryDirectory() as root:
        counts, steps, *_, t_data, t_run = cli_epochs(
            root, lambda: {k: v for k, v in launch_counts().items() if v},
            use_fused_train=True)
    depth = 12                               # ViT-S blocks
    want = {k: depth * steps for k in ("K3 fwd", "K3 bwd", "K4 fwd", "K4 bwd")}
    print(f"  launches over {steps} steps with use_fused_train: {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"expected {want}")
    t0 = time.perf_counter()
    iou0, iou1, _ = learning_check(300, 224, use_fused_train=True)
    print(f"  dataset {t_data:.1f} s, cli 2 epochs {t_run:.1f} s, learning check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not iou1 > 0.8:
        raise AssertionError(f"fused learning check failed: eval IoU {iou1}")
    phase(13, f"cli.train with use_fused_train: 2 epochs through K3 and K4; learning "
              f"check through the fused path eval IoU {iou0:.3f} -> {iou1:.3f} in 300 steps")
    return counts


K8 = {"name": "fused_vit_block_int8", "route": "cuda",
      "source": "sod_tpu_torch/csrc/fused_block_int8.cu",
      "replaces": "sod_tpu/ops/fused_block_int8.py:129"}
# K8 vs its plain version.  Both quantise the same f32 values except where an
# f32 sum taken in another order (LayerNorm's mean and variance) or a bf16
# rounding flip upstream (qkv, attention) moves a value across a .5 code
# boundary; one flipped code moves one term of one product by one code step,
# far below a bf16 ulp of the output.  So: the output within two bf16 ulps at
# its magnitude, and the share of codes that differ counted per stage (the
# first quantiser sees only LayerNorm's sum order; the later ones also every
# flip upstream of them; first H100 run: output max_abs one ulp, 0.03125, the
# first quantiser's share <= 7.3e-7, the later ones' <= 3.9e-4, never by more
# than one code)
K8_MAX_ULPS, K8_FIRST_FLIPS, K8_LATER_FLIPS, K8_MIN_CORR_K1 = 2, 1e-4, 5e-3, 0.999
SERVE_N = 785                            # tokens of a 224 px image at patch 8


def quantized(blk32):
    """The int8 record of an f32 ``Block`` on the card."""
    from sod_tpu_torch.ops.fused_block_int8 import quantize_vit_blocks

    state = {f"blocks.0.{k}": v for k, v in blk32.state_dict().items()}
    return quantize_vit_blocks(state, prefix="blocks.")[0]


def int8_kernel_check():
    """Phase 14: K8 against its plain version; returns the worst max_abs,
    {B: (K8 ms, plain ms, K1 ms)} and K8's bound at B=8."""
    import copy

    import torch

    from sod_tpu_torch.ops import fused_block as fb
    from sod_tpu_torch.ops import fused_block_int8 as fq

    rng = np.random.default_rng(14)
    worst = 0.0

    def tokens(b, n_pad, d):
        return torch.from_numpy(rng.standard_normal((b, n_pad, d), np.float32)
                                ).to(device="cuda", dtype=torch.bfloat16)

    def check(name, x, bq, h, n_real, mask):
        nonlocal worst
        sk, sr = {}, {}
        got = fq.fused_vit_block_int8(x, bq, h, n_real, key_mask=mask, scratch=sk)
        torch.cuda.synchronize()
        ref = fq.fused_vit_block_int8_reference(x, bq, h, n_real, key_mask=mask, scratch=sr)
        max_abs, rel_l2, corr = errors(got[:, :n_real], ref[:, :n_real])
        bound = K8_MAX_ULPS * bf16_ulp_at(ref[:, :n_real])
        ok = bool(torch.isfinite(got).all()) and max_abs <= bound and corr > KERNEL_MIN_CORR
        flips = []
        for i, st in enumerate(fq.MATS):
            dq = (sk[f"q_{st}"].int() - sr[f"q_{st}"].int()).abs()
            share = float((dq > 0).float().mean())
            ok = ok and share <= (K8_FIRST_FLIPS if i == 0 else K8_LATER_FLIPS)
            flips.append(f"{st} {int((dq > 0).sum())} of {dq.numel()} ({share:.2e}, "
                         f"by <= {int(dq.max())})")
        print(f"  {name}: max_abs {max_abs:.6g} (bound: {K8_MAX_ULPS} bf16 ulps, {bound:.6g}) "
              f"rel_l2 {rel_l2:.6g} corr {corr:.9f}; codes that differ: "
              f"{'; '.join(flips)} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"K8 disagrees with its plain version ({name})")
        worst = max(worst, max_abs)

    b, n_pad, d, h = 8, 896, 384, 6
    x = tokens(b, n_pad, d)
    key_mask = torch.from_numpy(rng.random((b, n_pad)) > 0.3).cuda()
    key_mask[:, 0] = True
    with torch.inference_mode():
        for name, perturbed, mask in (("unmasked, vit_init weights", False, None),
                                      ("unmasked, random biases/LN", True, None),
                                      ("masked, random biases/LN", True, key_mask)):
            bq = quantized(make_block(rng, d, h, perturbed, torch.float32))
            check(f"B={b} N={SERVE_N} (pad {n_pad}) d={d} {name}", x, bq, h, SERVE_N, mask)
        # the other widths the kernel takes: ViT-B (head dim 64) and ViT-Ti, small
        for dd, hh in ((768, 12), (192, 3)):
            bq = quantized(make_block(rng, dd, hh, True, torch.float32))
            check(f"B=2 N=200 (pad 256) d={dd} heads={hh} masked", tokens(2, 256, dd), bq, hh,
                  200, key_mask[:2, :256].contiguous())

        # the quantise launch alone on identical f32 rows: codes and scales equal.
        # Rows of mixed magnitude, a zero row (the amax floor) and a row of exact
        # .5 ties at scale 1 (round half to even)
        hrows = rng.standard_normal((7168, 1536), np.float32) \
            * rng.lognormal(0, 1, (7168, 1)).astype(np.float32)
        hrows[5] = 0
        hrows[6] = (np.arange(1536) % 250 - 125 + 0.5).astype(np.float32)
        hrows[6, 0] = 127
        hrows = torch.from_numpy(hrows).cuda()
        q_k, s_k = fq.quant_rows_cuda(hrows)
        torch.cuda.synchronize()
        q_p, s_p = fq.quant_rows(hrows)
        n_q, n_s = int((q_k != q_p).sum()), int((s_k != s_p[:, 0]).sum())
        print(f"  quantise launch alone, f32 rows {tuple(hrows.shape)}: {n_q} codes and {n_s} "
              f"scales differ from the plain quantiser (must be 0)", flush=True)
        if n_q or n_s:
            raise AssertionError("the row quantiser differs from its plain version")

        # the product launch alone with the QKV epilogue, on the same codes: exact
        m_rows = b * n_pad
        qa = torch.from_numpy(rng.integers(-127, 128, (m_rows, d), dtype=np.int8)).cuda()
        wq = torch.from_numpy(rng.integers(-127, 128, (3 * d, d), dtype=np.int8)).cuda()
        rs, ws, bias = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
            rng.random(m_rows) * 0.05, rng.random(3 * d) * 1e-3, rng.standard_normal(3 * d)))
        got = fq.qgemm_bias_bf16_cuda(qa, rs, wq, ws, bias)
        torch.cuda.synchronize()
        ref = (torch._int_mm(qa, wq.t()).float() * rs[:, None] * ws + bias).to(torch.bfloat16)
        n_diff = int((got != ref).sum())
        t_k = cuda_ms(lambda: fq.qgemm_bias_bf16_cuda(qa, rs, wq, ws, bias), 20)
        t_l = cuda_ms(lambda: torch._int_mm(qa, wq.t()), 20)
        print(f"  product launch alone, [{m_rows}, {d}] x [{d}, {3 * d}] s8 with the QKV "
              f"epilogue: {n_diff} of {got.numel()} outputs differ from torch._int_mm + the "
              f"same f32 epilogue (must be 0); {t_k:.4f} ms against torch._int_mm alone "
              f"{t_l:.4f} ms (a yardstick, not a route)", flush=True)
        if n_diff:
            raise AssertionError("the s8 product differs from the exact integer product")

        # K8 against K1 on the same block: the quantisation error
        blk32 = make_block(rng, d, h, True, torch.float32)
        bq, blk16 = quantized(blk32), copy.deepcopy(blk32).to(torch.bfloat16)
        out8 = fq.fused_vit_block_int8(x, bq, h, SERVE_N)
        out1 = fb.fused_vit_block(x, blk16, h, SERVE_N)
        max_abs, rel_l2, corr = errors(out8[:, :SERVE_N], out1[:, :SERVE_N])
        print(f"  K8 against K1 on the same block (the quantisation error): max_abs "
              f"{max_abs:.6g} rel_l2 {rel_l2:.6g} corr {corr:.9f}", flush=True)
        if not corr > K8_MIN_CORR_K1:
            raise AssertionError("K8 does not track the bf16 block")

        timings = {}
        for bb in (1, 8):
            xb = tokens(bb, n_pad, d)
            k8 = lambda: fq.fused_vit_block_int8(xb, bq, h, SERVE_N)      # noqa: E731
            k1 = lambda: fb.fused_vit_block(xb, blk16, h, SERVE_N)       # noqa: E731
            plain = lambda: fq.fused_vit_block_int8_reference(xb, bq, h, SERVE_N)  # noqa: E731
            # in turns on one card: plain, K8, K1, K1, K8, plain
            t = [cuda_ms(f, 20) for f in (plain, k8, k1, k1, k8, plain)]
            timings[bb] = ((t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2)
            print(f"  B={bb}: K8 {timings[bb][0]:.4f} ms, its plain version "
                  f"{timings[bb][1]:.4f} ms, K1 at the same shape {timings[bb][2]:.4f} ms "
                  f"per block call", flush=True)

    # bound at B=8 on the real tokens: the four projections at the s8 rate plus
    # the attention's two products at the bf16 rate, against x in and out, the
    # int8 weights and the f32 scales, biases and LayerNorm parameters
    hidden = bq["fc1"]["q"].shape[0]
    c = block_cost(b * SERVE_N, b, SERVE_N, d, hidden)
    n_bytes = (2 * 2 * b * SERVE_N * d + d * (4 * d + 2 * hidden)
               + 4 * (2 * (5 * d + hidden) + 4 * d))
    bound = roofline(c["qkv"] + c["proj"] + 2 * c["fc"], n_bytes, PEAK_INT8_OPS,
                     other_ops_ms=2 * c["scores"] / PEAK_BF16_FLOPS * 1e3)
    phase(14, f"K8 matches its plain version (output within {K8_MAX_ULPS} bf16 ulps; share of "
              f"codes that differ <= {K8_FIRST_FLIPS} at the first quantiser, <= "
              f"{K8_LATER_FLIPS} after it); quantiser and s8 product alone exact")
    return worst, timings, bound


def int8_serving_check(svc16, cfg16):
    """Phase 15: the int8 service beside the bf16 one (``svc16``, the same
    seeded weights); returns K8's launches on the main path's run."""
    import torch

    from PIL import Image

    from sod_tpu_torch.cli import predict as predict_cli
    from sod_tpu_torch.serving.inference import SelfMaskInference

    cfg = cfg16.replace(quantize="int8")
    t0 = time.perf_counter()
    svc = SelfMaskInference(cfg=cfg, device="cuda")
    try:
        rec = svc.model.encoder.blocks_q[0]
        print(f"  int8 service up in {time.perf_counter() - t0:.1f} s (weights seed {cfg.seed}, "
              f"{len(svc.model.encoder.blocks_q)} quantised blocks: codes "
              f"{rec['qkv']['q'].dtype}, scales {rec['qkv']['s'].dtype}, LayerNorm "
              f"{rec['norm1']['weight'].dtype}; micro-batching {svc.micro_batching})", flush=True)
        rng = np.random.default_rng(15)
        size = cfg.eval_image_size
        imgs = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
        batch = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)

        reset_launch_counts()
        steps = [svc.model_step(im) for im in imgs]
        m8, o8 = svc.forward_u8(batch)
        m8, o8 = m8.cpu().numpy(), o8.cpu().numpy()
        counts = {k: v for k, v in launch_counts().items() if v}
        depth, n_forwards = svc.mcfg.vit.depth, len(imgs) + 1
        print(f"  launches over {n_forwards} forwards: {counts} (expected K8 "
              f"{depth * n_forwards}, K1 none)", flush=True)
        if counts != {"K8": depth * n_forwards}:
            raise AssertionError(f"the int8 service launched {counts}")

        mask1 = np.stack([m for m, _ in steps]).astype(np.float32) / 255.0
        obj1 = np.stack([o for _, o in steps])
        side = size // svc.mcfg.vit.patch_size * svc.mcfg.scale_factor
        for m, o in steps + [(m8, o8)]:
            if not (np.isfinite(o).all() and o.shape[-1] == svc.mcfg.n_queries
                    and m.shape[-2:] == (side, side)):
                raise AssertionError(f"bad output: mask {m.shape}, obj {o.shape}")
        checks = [(f"model_step image {i}",
                   compare_with_plain(svc, imgs[i:i + 1], mask1[i:i + 1], obj1[i:i + 1]))
                  for i in range(len(imgs))]
        checks.append(("forward B=8", compare_with_plain(svc, batch, m8, o8)))
        for name, (obj_err, mask_max, mask_mean, agree) in checks:
            print(f"  {name}: objectness max_abs {obj_err:.6g}, mask max_abs "
                  f"{mask_max:.6g} mean_abs {mask_mean:.6g}, argmax agrees {agree}", flush=True)
            if obj_err > PATH_OBJ_TOL or mask_max > PATH_MASK_MAX or mask_mean > PATH_MASK_MEAN:
                raise AssertionError(f"the int8 path disagrees with its plain version ({name})")

        # against the bf16 service on the same weights and images: the cost of
        # quantisation on random weights (printed; the learning check holds the
        # trained weights to bars)
        m16, o16 = (t.cpu().numpy() for t in svc16.forward_u8(batch))
        same = int((o8.argmax(1) == o16.argmax(1)).sum())
        b8, b16 = m8 > 0.5, m16 > 0.5
        iou = float((b8 & b16).sum()) / max(float((b8 | b16).sum()), 1.0)
        print(f"  int8 against the bf16 service, B=8: objectness corr "
              f"{np.corrcoef(o8.ravel(), o16.ravel())[0, 1]:.6f} max_abs "
              f"{np.abs(o8 - o16).max():.6g}, the same query chosen for {same} of 8 images, "
              f"binarised-mask IoU {iou:.4f}, mask mean_abs {np.abs(m8 - m16).mean():.6g}",
              flush=True)

        # in turns on one card: int8, bf16, bf16, int8
        one = imgs[:1]
        lat = {}
        for tag, u8, iters in (("B=1", one, 30), ("B=8", batch, 20)):
            t = [host_ms(lambda s=s: s.forward_u8(u8), iters) for s in (svc, svc16, svc16, svc)]
            lat[tag] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        print(f"  forward_u8 in turns: B=1 int8 {lat['B=1'][0]:.3f} ms, bf16 "
              f"{lat['B=1'][1]:.3f} ms; B=8 int8 {lat['B=8'][0]:.3f} ms "
              f"({8e3 / lat['B=8'][0]:.1f} img/s), bf16 {lat['B=8'][1]:.3f} ms "
              f"({8e3 / lat['B=8'][1]:.1f} img/s)", flush=True)
        profile_steps(lambda _: svc.forward_u8(batch), None, 10, lat["B=8"][0],
                      unit="forward", watch={
                          "K8 (s8 products, row quantisers, attention)":
                          ("qgemm_kernel", "quant_rows_kernel", "attention_kernel"),
                          "of it the s8 products": ("qgemm_kernel",),
                          "of it the row quantisers": ("quant_rows_kernel",)})

        predict_requests(svc, cfg, "K8")

        # the predict CLI over a handful of PNGs, two of them with one stem
        with tempfile.TemporaryDirectory() as tmp:
            sizes = {"a/im0.png": (240, 320), "a/im1.png": (224, 224), "a/im2.png": (150, 380),
                     "b/im0.png": (200, 260), "b/im3.png": (300, 210)}
            for rel, (hh, ww) in sizes.items():
                os.makedirs(os.path.dirname(os.path.join(tmp, rel)), exist_ok=True)
                img = (rng.random((hh, ww, 3)) * 60).astype(np.uint8)
                img[hh // 4: 3 * hh // 4, ww // 3: 2 * ww // 3] += 150
                Image.fromarray(img).save(os.path.join(tmp, rel))
            out = os.path.join(tmp, "masks")
            reset_launch_counts()
            predict_cli.main(["--p_images", os.path.join(tmp, "a", "*.png"),
                              os.path.join(tmp, "b", "*.png"), "--out", out, "--config", CONFIG,
                              "--quantize", "int8", "--batch_size", "4", "--heatmap",
                              "--device", "cuda"])
            counts = {k: v for k, v in launch_counts().items() if v}
            want = {"im0": "a/im0.png", "im1": "a/im1.png", "im2": "a/im2.png",
                    "im0_1": "b/im0.png", "im3": "b/im3.png"}
            names = sorted(os.listdir(out))
            if names != sorted(f"{k}_{kind}.png" for k in want for kind in ("mask", "heatmap")):
                raise AssertionError(f"the predict CLI wrote {names}")
            for stem, rel in want.items():
                hh, ww = sizes[rel]
                mask = Image.open(os.path.join(out, f"{stem}_mask.png"))
                heat = Image.open(os.path.join(out, f"{stem}_heatmap.png"))
                if mask.size != (ww, hh) or mask.mode != "L" or heat.size != (ww, hh):
                    raise AssertionError(f"{stem}: mask {mask.size} {mask.mode} for {ww}x{hh}")
            print(f"  cli.predict --quantize int8: {len(names)} files for 5 images in batches "
                  f"of 4, launches {counts}", flush=True)
            if counts != {"K8": 2 * depth}:
                raise AssertionError(f"the predict CLI launched {counts}")
    finally:
        svc.close()
    phase(15, f"int8 service: {depth} K8 launches per forward, agrees with its plain version, "
              f"B=1 {lat['B=1'][0]:.3f} ms (bf16 {lat['B=1'][1]:.3f}), B=8 "
              f"{8e3 / lat['B=8'][0]:.1f} img/s (bf16 {8e3 / lat['B=8'][1]:.1f}); 3 /predict "
              f"answers and the predict CLI's masks")
    return depth * n_forwards


def main():
    card_check()
    import torch

    build_kernels()
    max_abs, timings = kernel_check()
    svc, cfg, launches = main_path()
    try:
        requests_phase(svc, cfg)
        # beside the bf16 service while it is up
        k8_worst, k8_times, k8_bound = int8_kernel_check()
        k8_launches = int8_serving_check(svc, cfg)
    finally:
        svc.close()
    k2_worst, k2_times = k2_check()
    train_step_check()
    k2_launches = trainer_check()
    ev = eval_kernels_check()
    ev_counts = evaluator_check()
    tk = fused_train_kernels_check()
    step_counts, _, _ = fused_train_step_check()
    tr = fused_trainer_check()
    fused_run, default_run = ev_counts["use_fused_eval"], ev_counts["default"]

    # bounds of K1 and K2 at the shapes they were timed at (B=8, 785 tokens)
    c = block_cost(TRAIN_B * TRAIN_N, TRAIN_B, TRAIN_N, 384, 1536)
    act = 2 * TRAIN_B * TRAIN_N * 384
    k1_bound = roofline(c["qkv"] + 2 * c["scores"] + c["proj"] + 2 * c["fc"],
                        2 * act + c["w_attn"] + c["w_mlp"])
    k2_bounds = k2_bound(*K2_TRAIN_SHAPE)
    k2_eval = k2_times["eval"]

    def entry(kernel, n_launches, err, ms, plain_ms, bound, library_ms=None):
        return dict(kernel, launches=n_launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound, library_ms=library_ms)

    report = [entry(KERNEL, launches, max_abs, *timings[8], k1_bound),
              entry(K8, k8_launches, k8_worst, *k8_times[8][:2], k8_bound),
              entry(K2_FWD, k2_launches[0], k2_worst["fwd"], *k2_times["fwd"],
                    k2_bounds["fwd"], k2_times["fwd_lib"]),
              entry(K2_BWD, k2_launches[1], k2_worst["bwd"], *k2_times["bwd"],
                    k2_bounds["bwd"], k2_times["bwd_lib"]),
              # the same kernel as default evaluation calls it (B=16, 2501 tokens, masked)
              entry(K2_FWD_EVAL, default_run["K2 fwd"], k2_worst["fwd"], k2_eval["ms"],
                    k2_eval["plain_ms"], k2_eval["bound"], k2_eval["library_ms"]),
              entry(K3_FWD, tr["K3 fwd"], *tk["K3 fwd"], tk["bound"]["K3 fwd"]),
              entry(K3_BWD, tr["K3 bwd"], *tk["K3 bwd"], tk["bound"]["K3 bwd"]),
              entry(K4_FWD, fused_run["K4 fwd"], *ev["K4"], ev["bound"]["K4"]),
              # K4's save forward runs under fused_save_acts: its step in phase 12
              entry(K4_SAVE, step_counts["fused_save_acts"]["K4 save"], *tk["K4 save"],
                    tk["bound"]["K4 save"]),
              entry(K4_BWD, tr["K4 bwd"], *tk["K4 bwd"], tk["bound"]["K4 bwd"]),
              entry(K5, fused_run["K5"], *ev["K5"], ev["bound"]["K5"]),
              entry(K6, default_run["K6"], *ev["K6"], ev["bound"]["K6"]),
              entry(K7, fused_run["K7"], *ev["K7"], ev["bound"]["K7"])]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
