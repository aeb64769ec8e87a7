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
   masked, and on 200 of 256 tokens at d 128, 256, 768 and 1024 (head dims
   32, 128, 64, 64); then both timed eagerly with CUDA events at B=1 and
   B=8, as serving calls them (the kernel chain also from a CUDA graph, its
   device time alone).  Then its GEMM alone: each of the four forward forms
   of ``gemm_kernel`` (LN + bias, residual -> f32, LN of f32 rows + GELU,
   residual -> bf16) at 896, 7168, 6336 and 40960 rows against its plain
   version (and two runs bit for bit), timed in turns with it and with
   ``torch.matmul`` on the same bf16 operands, all three from CUDA graphs,
   with TFLOP/s, the share of 989 TFLOP/s and the bound.  Then the backward
   of K3 and K4 alone at the fused train step's shapes (K3 on 7168 rows, K4
   on 6336; d 384, hidden 1536): the eight backward forms of
   ``gemm_kernel`` (NN: dattn -> bf16, dh -> f32, K4's dy . W2 with the
   GELU gradient on the f32 recompute and on the kept bf16 hidden, dh ->
   f32; TN: dWproj, dWqkv, dW2, dW1) and the LayerNorm backward, each
   against its plain version (bf16 within one ulp, f32 within 1e-5
   relative) and two runs bit for bit, timed the same way, with the plan,
   TFLOP/s, ``torch.matmul`` and the bound.  Then ``ops/layers.py``'s bf16
   linear at the ViT-S/8 train cell's shapes (B=64: QKV, proj, fc1, fc2 on
   50240 rows; the patch embedding, whose input needs no gradient, and the
   decoder's K/V on 50176; the decoder's query projection and FFN on 1280),
   then at the DINOv2 ViT-g/14-reg train cell's (B=8: qkv, proj, w12, w3 on
   10992 rows, the adapter and the decoder's K/V on 10952, its query
   projection on 160: row counts no multiple of 64):
   the f32-bias form of ``gemm_kernel`` alone against its plain version,
   and ``linear_tc`` forward and backward against ``linear_f32``, the f32
   products (y, dx, dW within one bf16 ulp, db within 1e-5 relative),
   device ms from CUDA graphs beside the f32 products, ``torch.mm(...,
   out_dtype=torch.float32)`` and the bound, and the host us a linear of
   both paths;
4. main path: the port's inference service at the full width of the
   shipped config (ViT-S/8 at 224 px, 6 decoder layers, 20 queries, bf16)
   with seeded random weights: ``model_step`` on 4 images and one B=8
   forward, the kernel's launch count (12 per forward), the ``linear_tc``
   calls (61 a forward at any batch: the patch embedding and the decoder's
   60; none left on the f32 products), agreement with the same forward
   through the plain version, B=1 latency and B=8 img/s;
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
   equal (and on [3, 2, 400, 397] with uint8 validity, its scalar path),
   one launch a call, K7 on [16, 20, 100, 100] -> 400 px within the count
   of pixels whose plain upsampled value lies within 1e-6 of 0.5; kernel
   and plain ms (K6 at B=16 and B=4, eager and from a CUDA graph, and its
   size sweep: B = 1, 4, 16 on 224 and 400 px canvases beside its plain
   version);
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
   that differ from the plain version's, counted; the kernel launches of
   one block call, from a profile (at most 6); the row-quantise launch
   alone on f32 rows (codes and scales equal) and the s8 product on given
   codes against ``torch._int_mm`` with the same epilogue (equal); the
   chain's four s8 products alone at B=8's 7168 rows (QKV with LN1, proj
   with the f32 residual, fc1 with LN2 and GELU, fc2 from the f32 hidden
   and fc1's row maxima), each against its plain version (codes that
   differ counted, outputs within K8's bounds), two runs bit for bit, its
   plan equal to ``s8_plan``'s, and timed from CUDA graphs beside its plain
   version, ``torch._int_mm`` on its codes (a yardstick, not a route), the
   bf16 form of the same product and its bound; K8 against K1 on the same
   block (the quantisation error); K8, its plain version and K1 timed in
   turns at B=1 and B=8;
15. int8 serving: the service with ``quantize: int8`` booted as phase 4's,
   12 K8 launches per forward and none of K1, agreement with the same
   service through the plain version and, printed, with the bf16 service on
   the same weights (objectness correlation, binarised-mask IoU); B=1
   latency and B=8 img/s of both services in turns; profiles of the int8
   and the bf16 B=8 forward (device busy of each, K8's share split into
   its s8 products and attention); three ``/predict`` requests; ``python -m
   sod_tpu_torch.cli.predict``'s ``main`` with ``--quantize int8`` over five
   PNGs (two with one stem) in batches of 4, its files checked.

Then, still beside the bf16 service:

17. refinement: ``/predict?refine=1`` through the web app with the service
   on 320x240, 1024x768 and 4000x3000 JPEG photos: 200, ``mask``,
   ``refined_mask`` and ``binary_mask`` at the upload's size, 12 K1
   launches a request; on each request's mask the refinement's pieces
   timed one by one (host grid, the device solve between CUDA events, the
   host post-step, PNG encode) and the card's solve held against the same
   solve on the CPU on one grid (``REFINE_SOFT_TOL``; the binary masks equal
   off that band); ``python -m sod_tpu_torch.cli.refine`` and ``cli.predict
   --refine`` once each on the card;
18. serving pool: ``python -m sod_tpu_torch.serving.app --workers 2 --device
   cuda`` as a subprocess on a file database; both worker pids answer
   ``/test_connection``; signup, then six ``/predict`` (two with
   ``refine=1``, solved on the workers' CPU) whose masks and objectness
   equal the in-process service's; the broker holds the card (its
   ``/dev/nvidia*`` files, and nvidia-smi's compute apps where they list
   this pid namespace) and no worker does; SIGTERM frees the port and ends
   every worker; the requests' ms;
19. ``python -m sod_tpu_torch.cli.smoke --device cuda`` passes, and
   ``cli.export`` of a checkpoint of the Trainer's format gives the
   reference's file, which a new service loads to the same masks.

Run after phase 13:

16. pseudo-mask generation at the live config's full width: ``MaskGenerator``
   (MoCo-v2 and SwAV dilated ResNet-50s and DINO ViT-S/16 with seeded random
   weights, spectral clustering at k 2, 3, 4 from one eigenbasis, x2
   feature upsample, B 16, the 784- and 3136-node subspace path) on 32
   synthetic 150-400 px images, with cuDNN's TF32 default on around it (the
   generator turns it off itself): every RLE 224 x 224, neither empty nor
   full; img/s; per backbone the device time of extract and cluster for a
   batch; the card against the port on the CPU for 4 images (features
   within 1e-3 relative, labels of each k agreeing on >= 0.98 of the nodes
   up to a permutation, from the card's features); printed, not held: the
   subspace labels against the dense ``eigh`` ones and the smallest gap
   among the first k + 1 eigenvalues; a profile of one batch (device busy,
   idle share); ``python -m sod_tpu_torch.cli.generate_masks``'s ``main`` on
   the card by default over the same images.

Then, after phase 16:

20. the model options off the live config, at its full width (224 px, 6
   decoder layers, 20 queries, seeded random weights): the service with
   ``arch: resnet50`` (dilated-8 ResNet-50, bf16) at B=1 and B=8 against the
   f32 forward of the same weights (TF32 off) and against its bf16 forward
   on the CPU (cuDNN's convolutions against the CPU's), and its forward ms;
   two ResNet-50 train steps at B=8 (every BN buffer moves, finite loss) and
   one f32 step at B=2 and 64 px against the same step on the CPU; two
   steps of the non-bc head at B=8 (dice, ranking and classification losses
   exactly 0, 12 + 12 K2 launches a step, ``linear_classifier`` and ``norm``
   moved by weight decay alone); the criterion's Hungarian branch at B=8,
   L=6, Q=20 on 56 x 56 predictions and 224 px GT under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), every
   assignment equal to scipy's on the same costs, its losses the CPU's, and
   its ms; ``vit_n_last_cls`` through K2 (12 launches) against the plain
   softmax.

Then, after phase 20:

21. the training options (ROADMAP item 6) at the live config's full width,
   on phase 7's synthetic batches: exact accumulation (GradCache) at B=16 as
   two micro-batches of 8, the labels repeated across them, through K2 (48
   forward + 24 backward launches a step) and under ``use_fused_train``
   (K3 and K4, 48 + 24 each): pass 1's features equal pass 2's, the summed
   gradients against one B=16 step (per tensor, max error over max
   magnitude: ``EXACT_GRAD_REL`` in bf16, ``EXACT_F32_GRAD_REL`` in f32 with
   plain attention), the step through the plain versions (phase 7's bounds),
   exact, averaged and one-batch step ms; remat at B=8 and B=32 (24 + 12 K2
   launches a step), under torch's deterministic algorithms: gradients bit
   for bit against the step without it, the step's peak device memory both
   ways, step ms both ways; ``cli.train --async-checkpoint`` for 2 epochs
   under the deterministic algorithms: ``latest_model.pt`` equal bit for bit
   to the weights at the ``save`` call and to a synchronous run's (and two
   synchronous runs equal), the training thread's ms in each checkpoint
   call, epoch s both ways, ``--resume``; the Trainer's visualizer hook (K1,
   12 launches a call) and the Evaluator's (K2) with PNGs where matplotlib
   imports, else a recording visualizer, said so; ``DataLoader`` with 4
   forked process workers after CUDA init, batches byte-equal to the thread
   loader's, img/s both ways.  Each line carries nvidia-smi's name and
   power limit.

Then, after phase 21:

22. the data mesh (ROADMAP item 12a) at the live config's full width, one
   rank over NCCL with every collective called (``make_mesh`` beyond the
   cards raises first): (a) two default steps (12 + 12 K2 launches a step),
   (b) two ``use_fused_train`` steps under ``fsdp: zero1`` (12 + 12 of K3
   and of K4 a step) and (c) two ``fsdp: full`` steps on the plain path,
   (b) and (c) sharded by the specs of two ranks so that the
   reduce-scatter and the all-gathers run; each against the same steps
   with no mesh under torch's deterministic algorithms, weights, moments
   and metrics within ``MESH_MAX_ABS``; (d) the Evaluator on 12 images at
   B=8 (K2 masked and K6 launches counted), its metrics equal to the run
   with no mesh; (e) ``MaskGenerator`` on 6 images at B=4, its JSON
   byte-equal to the run with no mesh; (g) the rank's rows of a synthetic
   DUTS-TR through ``DataLoader`` workers forked after NCCL is up, byte-equal
   to the thread loader's; (f) the default step's ms with and without the
   mesh, in turns;
23. the model-sharding layouts (ROADMAP item 12b) at the live config's full
   width, f32, the kernel flags off: ``cli.train --tp 2`` refused on one
   card before any rendezvous; the packed qkv split and merged back bit for
   bit; two ranks' arithmetic in one process (TP's two head groups'
   row-parallel partials against the whole block, SP's two query slices
   absorbing both key/value slices against dense attention); one step
   under each of TP, PP (M = 2), SP, p3 and sptp at one rank over NCCL
   against the step with no mesh (weights within ``LAYOUT_MAX_ABS``,
   moments and metrics within ``LAYOUT_MAX_REL``, no port kernel launched),
   their step ms in turns; the SP Evaluator on the 400 px canvas against
   the run with no mesh; four ranks' arithmetic at model 4, which cuts
   ViT-S's 6 heads (q, k and v gathered, four proj and fc2 partials),
   against the whole block;
24. ``sod_tpu_torch/dryrun.py`` at one NCCL rank: the dryrun's phases 1, 2,
   2b, 3 and 4 (two data-mesh steps and the IoU, averaged and exact
   accumulation, resume from the ``.pt``, the Evaluator over the mesh), each
   held to the one-device run at the reference's tolerances; the others
   need two or more ranks (phase 8 a data axis above 1); then ``entry()``,
   the flagship forward at full width on a zero bf16 image: its 12 K2
   forward launches, each against K2's plain version on the same inputs
   within phase 6's bounds, the outputs against the forward through the
   plain version (printed), and both forwards' ms.

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
K2_FWD_VITG = dict(K2_FWD, name="flash_attention_forward_vitg14reg_shape")
K2_BWD_VITG = dict(K2_BWD, name="flash_attention_backward_vitg14reg_shape")
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


CARD = "card not checked"                 # nvidia-smi's name and power limit


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def card_check():
    # cuBLAS's fixed workspace, read when its first handle is made: phase 21
    # runs steps under torch's deterministic algorithms, which require it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
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
            elif "wgmma" in ln:       # e.g. products serialised by ptxas
                lines.append(f"  ptxas: {ln.strip()}")
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


def graph_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device ms of ``fn`` from CUDA events around replays of a CUDA graph
    holding ``iters`` calls: the host's launch cost, which exceeds the
    device time of a small kernel, is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm up (and build) off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# the fused block's widths beyond the served one (d, heads), each masked on
# 200 of 256 tokens: head dims 32 and 128, and the LN panel's extremes
K1_WIDTHS = ((128, 4), (256, 2), (768, 12), (1024, 16))


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

        # the other head widths the kernel is built for (32, 128) and the
        # widths at the LN panel's extremes, 200 of 256 tokens
        for dd, hh in K1_WIDTHS:
            blk = make_block(rng, dd, hh, True)
            xs = torch.from_numpy(rng.standard_normal((2, 256, dd), np.float32)
                                  ).to(device="cuda", dtype=torch.bfloat16)
            ks = key_mask[:, :256].contiguous()
            got = fb.fused_vit_block(xs, blk, hh, 200, key_mask=ks)
            torch.cuda.synchronize()
            ref = fb.fused_vit_block_reference(xs, blk, hh, 200, key_mask=ks)
            max_abs, rel_l2, corr = errors(got[:, :200], ref[:, :200])
            print(f"  d {dd}, head dim {dd // hh}, masked: max_abs {max_abs:.6g} rel_l2 "
                  f"{rel_l2:.6g} corr {corr:.9f}", flush=True)
            if not (max_abs <= KERNEL_MAX_ABS and corr > KERNEL_MIN_CORR):
                raise AssertionError(f"kernel disagrees at d {dd}, head dim {dd // hh}")

        timings = {}
        blk = make_block(rng, d, h, True)
        for bb in (1, 8):
            xb = torch.from_numpy(rng.standard_normal((bb, n_pad, d), np.float32)
                                  ).to(device="cuda", dtype=torch.bfloat16)
            kern = lambda: fb.fused_vit_block(xb, blk, h, n_real)
            plain = lambda: fb.fused_vit_block_reference(xb, blk, h, n_real)
            # in turns on one card: plain, kernel, kernel graph, kernel graph,
            # kernel, plain.  Kernel and plain are both eager, as serving
            # calls them (the host's launches included); the graph time is
            # the chain's device time alone, printed beside it
            p1, k1, g1, g2, k2, p2 = (cuda_ms(plain, 20), cuda_ms(kern, 20), graph_ms(kern),
                                      graph_ms(kern), cuda_ms(kern, 20), cuda_ms(plain, 20))
            timings[bb] = ((k1 + k2) / 2, (p1 + p2) / 2, (g1 + g2) / 2)
            print(f"  B={bb}: kernel {timings[bb][0]:.4f} ms (from a CUDA graph "
                  f"{timings[bb][2]:.4f} ms), plain {timings[bb][1]:.4f} ms per block call",
                  flush=True)
    phase(3, f"fused block matches its plain version (max_abs <= "
             f"{KERNEL_MAX_ABS}, corr > {KERNEL_MIN_CORR})")
    return worst, timings


GEMM = {"route": "cuda", "source": "sod_tpu_torch/csrc/vit_block.cuh",
        "replaces": "sod_tpu/ops/fused_block.py:42"}
# The four forward forms of gemm_kernel as K1 calls them at d 384, hidden
# 1536: (name, epilogue, LayerNorm, a's dtype, res's dtype, N, K)
GEMM_FORMS = (("qkv", "bias_bf16", True, "bfloat16", None, 1152, 384),
              ("proj", "res_f32", False, "bfloat16", "bfloat16", 384, 384),
              ("fc1", "gelu_bf16", True, "float32", None, 1536, 384),
              ("fc2", "res_bf16", False, "bfloat16", "float32", 384, 1536))
# rows: K1 at B=1 and B=8 (896 tokens a served image), K4 at the fused
# train step (6280 rows padded to 6336) and at fused eval (B=16 x 2560)
GEMM_ROWS = (896, 7168, 6336, 40960)
GEMM_REPORT_ROWS = 7168                  # the kernel line's GEMM entries: K1 at B=8
# kernel vs plain version: bf16 outputs within one bf16 ulp at the output's
# magnitude (the rounding points are the plain version's; f32 sums in
# another order flip single roundings), f32 outputs within 1e-5 of it
GEMM_F32_REL = 1e-5


def gemm_bound(m: int, n: int, k: int, epilogue: str, ln: bool, a_bytes: int,
               res_bytes: int) -> dict:
    """The least time the card could take for one GEMM form: 2 m n k
    products at the bf16 peak, against a (m x k of ``a_bytes``), W (n x k
    bf16), the bias, the LN parameters, the residual and the output, each
    moved once."""
    out_bytes = 4 if epilogue == "res_f32" else 2
    bias_bytes = 4 if epilogue == "f32bias_bf16" else 2
    n_bytes = (m * k * a_bytes + 2 * n * k + bias_bytes * n + (4 * k if ln else 0)
               + m * n * (res_bytes + out_bytes))
    return roofline(2.0 * m * n * k, n_bytes)


def gemm_check():
    """Phase 3, GEMMs: each forward form of gemm_kernel at each of
    ``GEMM_ROWS`` against its plain version, two runs bit for bit; then in
    turns with its plain version and ``torch.matmul`` on the same bf16
    operands (cuBLAS, a yardstick the port never calls), beside its bound.
    Returns {form: (max_abs, ms, plain_ms, bound, matmul_ms)} at
    ``GEMM_REPORT_ROWS``."""
    import re

    import torch

    from sod_tpu_torch.ops import gemm as G

    rng = np.random.default_rng(3)

    def mk(shape, dtype, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale).to(
            device="cuda", dtype=getattr(torch, dtype))

    report = {}
    for m in GEMM_ROWS:
        for name, epi, ln, a_t, res_t, n, k in GEMM_FORMS:
            a = mk((m, k), a_t)
            w, bias = mk((n, k), "bfloat16", 0.02), mk((n,), "bfloat16", 0.02)
            lnp = ((1 + mk((k,), "float32", 0.1)).to(torch.bfloat16),
                   mk((k,), "bfloat16", 0.1)) if ln else None
            res = mk((m, n), res_t) if res_t else None
            before = G.launches
            got = G.gemm(a, w, bias, epi, ln=lnp, res=res)
            again = G.gemm(a, w, bias, epi, ln=lnp, res=res)
            torch.cuda.synchronize()
            if G.launches - before != 2:
                raise AssertionError(f"gemm counted {G.launches - before} launches for 2 calls")
            ref = G.gemm_reference(a, w, bias, epi, ln=lnp, res=res)
            max_abs = float((got.float() - ref.float()).abs().max())
            limit = (bf16_ulp_at(ref) if got.dtype == torch.bfloat16
                     else GEMM_F32_REL * float(ref.abs().max()))
            ok = bool(torch.isfinite(got).all()) and max_abs <= limit and torch.equal(got, again)
            a16 = a.to(torch.bfloat16)
            kern = lambda: G.gemm(a, w, bias, epi, ln=lnp, res=res)
            plain = lambda: G.gemm_reference(a, w, bias, epi, ln=lnp, res=res)
            lib = lambda: torch.matmul(a16, w.t())
            # all three from CUDA graphs: device time, the host's launches left out
            p1, k1, l1, k2, l2, p2 = (graph_ms(plain, 5), graph_ms(kern), graph_ms(lib),
                                      graph_ms(kern), graph_ms(lib), graph_ms(plain, 5))
            ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
            bound = gemm_bound(m, n, k, epi, ln, a.element_size(),
                               0 if res is None else res.element_size())
            flops = 2.0 * m * n * k
            cfg, tiles, _ = G.plan(ln, m, n, k)
            rows, cols = (int(v) for v in re.search(r"(\d+)x(\d+)", cfg).groups())
            items = -(-m // rows) * -(-(n // cols) // tiles)
            print(f"  {name:4s} M {m:5d} N {n:4d} K {k:4d} ({cfg}, {tiles} column tiles an "
                  f"item, {items} items = {items / torch.cuda.get_device_properties(0).multi_processor_count:.2f} per SM): "
                  f"max_abs {max_abs:.4g} (<= {limit:.4g}), runs equal; kernel {ms:.4f} ms "
                  f"{flops / ms / 1e9:.1f} TFLOP/s {100 * flops / ms / 1e9 / 989:.1f}% of 989, "
                  f"matmul {lib_ms:.4f} ms {100 * flops / lib_ms / 1e9 / 989:.1f}%, plain "
                  f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
                  f"-> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"gemm {name} at M {m} disagrees with its plain version "
                                     f"or between runs")
            if m == GEMM_REPORT_ROWS:
                report[name] = (max_abs, ms, plain_ms, bound, lib_ms)
    phase(3, f"gemm_kernel's four forward forms match their plain versions at M in "
             f"{GEMM_ROWS} (bf16 within one ulp, f32 within {GEMM_F32_REL} relative)")
    return report


# The backward forms of gemm_kernel as K3's and K4's chains call them at the
# fused train step (B=8, 785 tokens: K3 on 8 x 896 = 7168 rows, K4 on 6280
# rows padded to 6336; d 384, hidden 1536): (name, layout, rows, N, K, epilogue)
# for NN, C[rows, N] = A[rows, K] . W[K, N]; for TN, C[N, K] = A[rows, N]^T .
# B[rows, K] (the contracted rows are `rows`)
GEMM_BWD_FORMS = (("k3_dattn", "nn", 7168, 384, 384, "bf16"),
                  ("k3_dh", "nn", 7168, 384, 1152, "f32"),
                  ("k3_dwproj", "tn", 7168, 384, 384, None),
                  ("k3_dwqkv", "tn", 7168, 1152, 384, None),
                  ("k4_dgelu", "nn", 6336, 1536, 384, "dgelu"),           # fc1 recomputed inside
                  ("k4_dh", "nn", 6336, 384, 1536, "f32"),
                  ("k4_dw2", "tn", 6336, 384, 1536, None),
                  ("k4_dw1", "tn", 6336, 1536, 384, None))
LN_BWD_ROWS = (("k3", 7168), ("k4", 6336))      # the LayerNorm backward at d 384
GEMM_BWD = dict(GEMM, replaces="sod_tpu/ops/fused_attn.py:182")
GEMM_BWD_K4 = dict(GEMM, replaces="sod_tpu/ops/fused_mlp.py:122")


def gemm_bwd_bound(layout: str, rows: int, n: int, k: int, epilogue) -> dict:
    """The least time for one backward form: its products at the bf16 peak
    against its operands and outputs, each moved once (NN: A, W, the output;
    the GELU gradient also writes gel and the f32 column sums, and reads the
    kept bf16 hidden ("dgelu_kept") or recomputes it, a second product over
    h, W1 and b1 ("dgelu"); TN: A, B and the f32 [N, K] output)."""
    if layout == "tn":
        return roofline(2.0 * rows * n * k, 2 * rows * (n + k) + 4 * n * k)
    flops, n_bytes = 2.0 * rows * n * k, 2 * rows * k + 2 * k * n
    if epilogue == "dgelu":
        flops, n_bytes = 2 * flops, 2 * n_bytes + 2 * n
    out = {"bf16": 2, "f32": 4, "dgelu": 2 + 2, "dgelu_kept": 2 + 2 + 2}[epilogue]
    return roofline(flops, n_bytes + rows * n * out + (4 * n if "dgelu" in epilogue else 0))


def ln_bwd_bound(rows: int, d: int) -> dict:
    """x bf16, dh f32, g bf16 and ln_w read, dx bf16 and three f32 column
    sums written; its arithmetic is far below the bytes."""
    return roofline(0.0, rows * d * (2 + 4 + 2 + 2) + 2 * d + 12 * d)


def gemm_bwd_check():
    """Phase 3, the backward: each of the eight backward forms of
    gemm_kernel (and the dgelu form on a kept bf16 hidden) and the
    LayerNorm backward at the fused train step's shapes against its plain
    version, two runs bit for bit, then timed from CUDA graphs in turns with
    its plain version and ``torch.matmul`` on the same bf16 operands, beside
    its bound.  Returns {name: (max_abs, ms, plain_ms, bound, matmul_ms,
    extra keys for the kernel line)}."""
    import torch

    from sod_tpu_torch.ops import gemm as G

    rng = np.random.default_rng(4)

    def mk(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale).to(
            device="cuda", dtype=dtype)

    def held(got, ref):
        """max_abs and its limit: one bf16 ulp at the output's magnitude, or
        GEMM_F32_REL of it for f32"""
        max_abs = float((got.float() - ref.float()).abs().max())
        limit = (bf16_ulp_at(ref) if got.dtype == torch.bfloat16
                 else GEMM_F32_REL * float(ref.abs().max()))
        return max_abs, limit, bool(torch.isfinite(got).all()) and max_abs <= limit

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report = {}
    forms = list(GEMM_BWD_FORMS) + [("k4_dgelu_kept", "nn", 6336, 1536, 384, "dgelu_kept")]
    for name, layout, rows, n, k, epi in forms:
        if layout == "nn":
            a, w = mk((rows, k), 0.5), mk((k, n), 0.02)
            pre, dgelu, flops = None, None, 2.0 * rows * n * k
            kind = "dgelu" if "dgelu" in epi else epi
            lib = lambda: torch.matmul(a, w)
            if epi == "dgelu_kept":
                pre, dgelu = mk((rows, n)), "kept"
            elif epi == "dgelu":
                # the hidden recomputed inside: h . W1^T + b1, a second product
                h1, w1, b1 = mk((rows, k)), mk((n, k), 0.1), mk((n,), 0.1)
                pre, dgelu, flops = (h1, w1, b1), "recomputed", 2 * flops
                lib = lambda: (torch.matmul(a, w), torch.matmul(h1, w1.t()))
            kern = lambda: G.gemm_nn(a, w, kind, pre)
            plain = lambda: G.gemm_nn_reference(a, w, kind, pre)
            counter = "nn_launches"
            cfg, tiles, split = G.plan(False, rows, n, k, "nn", dgelu)
            items = -(-rows // (128 if cfg.endswith("128x128") else 64)) * -(
                -(n // int(cfg.rsplit("x", 1)[1])) // tiles)
            how = f"{cfg}, {tiles} column tiles an item"
        else:
            a, b = mk((rows, n), 0.5), mk((rows, k), 0.5)
            kern = lambda: G.gemm_tn(a, b)
            plain = lambda: G.gemm_tn_reference(a, b)
            lib = lambda: torch.matmul(a.t(), b)
            counter, flops = "tn_launches", 2.0 * rows * n * k
            cfg, tiles, split = G.plan(False, n, k, rows, "tn")
            tile_r = 128 if cfg.endswith("128x128") else 64
            items = (n // tile_r) * (k // int(cfg.rsplit("x", 1)[1])) * -(-rows // split)
            how = f"{cfg}, {split} rows a split"
        before = getattr(G, counter)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if getattr(G, counter) - before != 2:
            raise AssertionError(f"{name}: {getattr(G, counter) - before} launches counted for 2 calls")
        ref = plain()
        got, again, ref = ((t,) if torch.is_tensor(t) else t for t in (got, again, ref))
        checks = [held(x, r) for x, r in zip(got, ref)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = same and all(c[2] for c in checks)
        p1, k1, l1, k2, l2, p2 = (graph_ms(plain, 5), graph_ms(kern), graph_ms(lib),
                                  graph_ms(kern), graph_ms(lib), graph_ms(plain, 5))
        ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
        bound = gemm_bwd_bound(layout, rows, n, k, epi)
        print(f"  {name:13s} {layout} rows {rows} N {n} K {k} ({how}, {items} items = "
              f"{items / sms:.2f} per SM): max_abs "
              + " / ".join(f"{c[0]:.4g} (<= {c[1]:.4g})" for c in checks)
              + f", runs equal {same}; kernel {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s "
              f"{100 * flops / ms / 1e9 / 989:.1f}% of 989, "
              f"{'two matmuls' if epi == 'dgelu' else 'matmul'} {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x), plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}, {ms / bound['bound_ms']:.2f}x) -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version or between runs")
        # one torch.matmul call computes the product, not the recomputing
        # form's two: those are kept beside it, not as its library call
        report[name] = (max(c[0] for c in checks), ms, plain_ms, bound,
                        None if epi == "dgelu" else lib_ms,
                        {"two_matmuls_ms": lib_ms} if epi == "dgelu" else {})

    for tag, rows in LN_BWD_ROWS:
        d = 384
        x, dh, g = mk((rows, d), 2.0), mk((rows, d), 0.05, torch.float32), mk((rows, d), 0.5)
        ln_w = (1 + mk((d,), 0.1, torch.float32)).to(torch.bfloat16)
        before = G.ln_bwd_launches
        got, again = G.ln_backward(x, dh, g, ln_w), G.ln_backward(x, dh, g, ln_w)
        torch.cuda.synchronize()
        if G.ln_bwd_launches - before != 2:
            raise AssertionError("ln_backward: launches not counted")
        ref = G.ln_backward_reference(x, dh, g, ln_w)
        checks = [held(a_, r) for a_, r in zip(got, ref)]
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        kern = lambda: G.ln_backward(x, dh, g, ln_w)
        plain = lambda: G.ln_backward_reference(x, dh, g, ln_w)
        p1, k1, k2, p2 = graph_ms(plain, 5), graph_ms(kern), graph_ms(kern), graph_ms(plain, 5)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound = ln_bwd_bound(rows, d)
        ok = same and all(c[2] for c in checks)
        print(f"  ln_backward_{tag} rows {rows} d {d}: max_abs dx / dLN scale / dLN bias / sum g "
              + " / ".join(f"{c[0]:.4g} (<= {c[1]:.4g})" for c in checks)
              + f", runs equal {same}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {ms / bound['bound_ms']:.2f}x) "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ln_backward at {rows} rows disagrees with its plain version "
                                 f"or between runs")
        report[f"ln_backward_{tag}"] = (max(c[0] for c in checks), ms, plain_ms, bound, None, {})
    phase(3, f"gemm_kernel's {len(GEMM_BWD_FORMS)} backward forms (and dgelu on a kept hidden) "
             f"and the LayerNorm backward match their plain versions at the fused train "
             f"step's shapes (bf16 within one ulp, f32 within {GEMM_F32_REL} relative), runs "
             f"bit for bit")
    return report


# ops/layers.py linear at the shapes of the vits8-train-b64 cell (B=64, 785
# tokens: 50240 rows; 784 patches an image: 50176 rows, the patch embedding
# and the decoder's K and V; 20 queries an image: 1280 rows, the decoder's
# query and output projections and its FFN), then of the vitg14reg-train-b8
# cell (B=8, 1374 tokens: 10992 rows, 48 past a multiple of 64, through
# DINOv2 ViT-g's qkv, proj, SwiGLU w12 and w3; 1369 patches an image: 10952
# rows, 8 past, the adapter and the decoder's K and V; 160 query rows):
# (name, rows, N, K, x needs a gradient; the patch embedding's image does
# not).  Bf16 linears with a bias whose shapes gemm_kernel takes run
# ops/gemm.py linear_tc: the "f32bias_bf16" form forward, gemm_nn (only
# where x needs a gradient) and gemm_tn backward.
LINEAR_SHAPES = (("qkv", 50240, 1152, 384, True), ("proj", 50240, 384, 384, True),
                 ("fc1", 50240, 1536, 384, True), ("fc2", 50240, 384, 1536, True),
                 ("patch", 50176, 384, 192, False), ("dec_kv", 50176, 384, 384, True),
                 ("dec_q", 1280, 384, 384, True), ("dec_fc1", 1280, 1536, 384, True),
                 ("dec_fc2", 1280, 384, 1536, True),
                 ("g_qkv", 10992, 4608, 1536, True), ("g_proj", 10992, 1536, 1536, True),
                 ("g_w12", 10992, 8192, 1536, True), ("g_w3", 10992, 1536, 4096, True),
                 ("g_adapter", 10952, 384, 1536, True), ("g_dec_kv", 10952, 384, 384, True),
                 ("g_dec_q", 160, 384, 384, True))
LINEAR = {"route": "cuda", "source": "sod_tpu_torch/csrc/vit_block.cuh",
          "replaces": "sod_tpu/ops/layers.py:98"}
# host us a linear: LINEAR_HOST_CALLS linears on their own inputs and weights,
# forward then one backward over all of them (one hand-off to autograd's
# device thread, as in a step), LINEAR_HOST_REPS times
LINEAR_HOST_CALLS, LINEAR_HOST_REPS = 16, 7


def linear_bound(m: int, n: int, k: int, dx: bool = True) -> dict:
    """The least time for ``linear_tc`` forward and backward: three products
    of 2 m n k at the bf16 peak (two without dx), against x, W and the f32
    bias read and y written (forward), then dy read twice (once), W (only
    for dx) and x read, dx (only with it) and the f32 dW and db written
    (backward), each once."""
    uses = 3 if dx else 2
    return roofline(2.0 * uses * m * n * k,
                    uses * 2 * m * k + uses * 2 * m * n + (uses - 1) * 2 * n * k
                    + 4 * n * k + 2 * 4 * n)


def linear_host_us(fn, xs, ws, bs, gy, reps: int = LINEAR_HOST_REPS) -> float:
    """Median host-clock us a linear of ``fn(x, w, b)`` over the inputs
    ``xs``, ``ws``, ``bs``: every forward, then one backward over their
    outputs, issued after a synchronize (the card runs behind: nothing
    inside waits for it), over ``reps`` rounds."""
    import torch

    def run():
        for t in (*xs, *ws, *bs):
            t.grad = None
        ys = [fn(x, w, b) for x, w, b in zip(xs, ws, bs)]
        torch.autograd.backward(ys, [gy] * len(ys))

    run()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t) / len(xs))
    torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6


def linear_check():
    """Phase 3, the bf16 linear: at each of ``LINEAR_SHAPES`` the
    "f32bias_bf16" form alone against its plain version (one bf16 ulp), two
    runs bit for bit, timed from CUDA graphs in turns with it and with
    ``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS, a yardstick the port
    never calls); then ``linear`` forward and backward through ``linear_tc``
    against the same call on the f32 products (``linear_f32``): y, dx and dW
    within one bf16 ulp, db within ``GEMM_F32_REL``; both timed in turns from
    CUDA graphs, beside the bound and the library's products; and the host us
    a linear of each (``linear_host_us``).
    Returns {name: (form entry, Function entry)} as tuples for the report."""
    import torch

    from sod_tpu_torch.ops import gemm as G
    from sod_tpu_torch.ops import layers as L

    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16

    def mk(shape, scale=1.0, dtype=bf16):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale).to(
            device="cuda", dtype=dtype)

    def mm32(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    def held(got, ref, f32=False):
        max_abs = float((got.detach().float() - ref.detach().float()).abs().max())
        limit = GEMM_F32_REL * float(ref.abs().max()) if f32 else bf16_ulp_at(ref)
        return max_abs, limit, bool(torch.isfinite(got).all()) and max_abs <= limit

    report = {}
    for name, m, n, k, x_grad in LINEAR_SHAPES:
        x, w, b = mk((m, k)), mk((n, k), 0.02, torch.float32), mk((n,), 0.02, torch.float32)
        w16 = w.to(bf16)
        before = G.launches
        got, again = G.gemm(x, w16, b, "f32bias_bf16"), G.gemm(x, w16, b, "f32bias_bf16")
        torch.cuda.synchronize()
        if G.launches - before != 2:
            raise AssertionError(f"gemm counted {G.launches - before} launches for 2 calls")
        form = held(got, G.gemm_reference(x, w16, b, "f32bias_bf16"))
        same = torch.equal(got, again)
        kern = lambda: G.gemm(x, w16, b, "f32bias_bf16")
        plain = lambda: G.gemm_reference(x, w16, b, "f32bias_bf16")
        wt = w16.t()
        lib = lambda: mm32(x, wt)
        p1, k1, l1, k2, l2, p2 = (graph_ms(plain, 5), graph_ms(kern), graph_ms(lib),
                                  graph_ms(kern), graph_ms(lib), graph_ms(plain, 5))
        ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
        bound = gemm_bound(m, n, k, "f32bias_bf16", False, 2, 0)
        flops = 2.0 * m * n * k
        cfg, tiles, _ = G.plan(False, m, n, k)
        print(f"  linear form {name:7s} M {m} N {n} K {k} ({cfg}, {tiles} column tiles an "
              f"item): max_abs {form[0]:.4g} (<= {form[1]:.4g}), runs equal {same}; kernel "
              f"{ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s {100 * flops / ms / 1e9 / 989:.1f}% "
              f"of 989, torch.mm out_dtype f32 {lib_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {ms / bound['bound_ms']:.2f}x) "
              f"-> {'ok' if form[2] and same else 'FAIL'} [{CARD}]", flush=True)
        if not (form[2] and same):
            raise AssertionError(f"linear form {name} disagrees with its plain version or "
                                 f"between runs")

        # the whole Function against the f32 products, forward and backward
        gy = mk((m, n), 0.5)
        xs = [x.clone().requires_grad_(x_grad) for _ in range(2)]
        ws = [w.clone().requires_grad_() for _ in range(2)]
        bs = [b.clone().requires_grad_() for _ in range(2)]

        def call(fn, i):
            # y comes back without its autograd graph: a graph kept alive
            # keeps the leaves' AccumulateGrad nodes on the stream they were
            # made on (the legacy stream here), and a CUDA graph's captured
            # backward would then make that stream wait on the capturing one
            xs[i].grad = ws[i].grad = bs[i].grad = None
            y = fn(xs[i], ws[i], bs[i])
            y.backward(gy)
            return y.detach()

        before = (L.tc_linears, G.launches, G.nn_launches, G.tn_launches)
        y_tc = call(L.linear, 0)
        after = (L.tc_linears, G.launches, G.nn_launches, G.tn_launches)
        y_32 = call(L.linear_f32, 1)
        torch.cuda.synchronize()
        want = (1, 1, int(x_grad), 1)
        if tuple(a - c for a, c in zip(after, before)) != want:
            raise AssertionError(f"linear {name}: {after} after {before}, want {want}: one "
                                 f"call through linear_tc and one launch of each product")
        checks = [held(y_tc, y_32), held(ws[0].grad, ws[1].grad),
                  held(bs[0].grad, bs[1].grad, f32=True)]
        if x_grad:
            checks.insert(1, held(xs[0].grad, xs[1].grad))
        ok = (all(c[2] for c in checks) and ws[0].grad.dtype == torch.float32
              and (x_grad or xs[0].grad is None))
        tc = lambda: call(L.linear, 0)
        f32 = lambda: call(L.linear_f32, 1)
        gyt = gy.t()
        lib_fns = (lambda: mm32(x, wt), lambda: mm32(gy, w16), lambda: mm32(gyt, x))
        if not x_grad:
            lib_fns = lib_fns[0], lib_fns[2]
        libs = lambda: [f() for f in lib_fns]
        f1, t1, t2, f2 = graph_ms(f32, 5), graph_ms(tc, 10), graph_ms(tc, 10), graph_ms(f32, 5)
        fn_ms, f32_ms = (t1 + t2) / 2, (f1 + f2) / 2
        libs_ms = (graph_ms(libs, 5) + graph_ms(libs, 5)) / 2
        many = [[t.detach().clone().requires_grad_(t is not x or x_grad)
                 for _ in range(LINEAR_HOST_CALLS)] for t in (x, w, b)]
        h32a, htca, htcb, h32b = (linear_host_us(f, *many, gy)
                                  for f in (L.linear_f32, L.linear, L.linear, L.linear_f32))
        h_tc, h_32 = (htca + htcb) / 2, (h32a + h32b) / 2
        del many
        fb = linear_bound(m, n, k, x_grad)
        print(f"  linear {name:7s} forward + backward: max_abs y / "
              f"{'dx / ' if x_grad else ''}dW / db "
              + " / ".join(f"{c[0]:.4g} (<= {c[1]:.4g})" for c in checks)
              + f"; linear_tc {fn_ms:.4f} ms ({len(lib_fns) * flops / fn_ms / 1e9:.1f} "
              f"TFLOP/s), f32 products {f32_ms:.3f} ms ({f32_ms / fn_ms:.2f}x), torch.mm "
              f"out_dtype f32 x{len(lib_fns)} {libs_ms:.4f} ms, bound {fb['bound_ms']:.4f} ms "
              f"({fb['bound_by']}, {fn_ms / fb['bound_ms']:.2f}x); host us a call {h_tc:.1f} "
              f"linear_tc vs {h_32:.1f} f32 -> {'ok' if ok else 'FAIL'} [{CARD}]", flush=True)
        if not ok:
            raise AssertionError(f"linear {name} through linear_tc disagrees with the f32 "
                                 f"products")
        report[name] = ((form[0], ms, plain_ms, bound, lib_ms),
                        (max(c[0] for c in checks), fn_ms, f32_ms, fb, libs_ms,
                         {"host_us": h_tc, "plain_host_us": h_32}))
        del x, w, b, w16, gy, xs, ws, bs, y_tc, y_32
        torch.cuda.empty_cache()
    phase(3, f"the bf16 linear (linear_tc: the f32-bias form, gemm_nn, gemm_tn) matches its "
             f"plain version and the f32 products at {len(LINEAR_SHAPES)} shapes of the train "
             f"cells")
    return report


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
    from sod_tpu_torch.ops import gemm as G
    from sod_tpu_torch.ops import layers as L
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

    fb.launches = L.tc_linears = L.f32_linears = G.launches = 0
    steps = [svc.model_step(im) for im in imgs]
    step_linears = L.tc_linears, G.launches, L.f32_linears
    m8, o8 = svc.forward_u8(batch)
    m8, o8 = m8.cpu().numpy(), o8.cpu().numpy()
    b8_linears = tuple(a - c for a, c in zip((L.tc_linears, G.launches, L.f32_linears),
                                             step_linears))
    launches = fb.launches
    n_forwards = len(imgs) + 1
    depth = svc.mcfg.vit.depth
    print(f"  fused block launches: {launches} over {n_forwards} forwards; linear_tc calls "
          f"/ f32-bias form launches / bf16 linears left on f32: {step_linears} over "
          f"{len(imgs)} model_step calls (784 patch rows), {b8_linears} in the B=8 forward",
          flush=True)
    if launches != depth * n_forwards:
        raise AssertionError(f"expected {depth} launches per forward, got "
                             f"{launches} for {n_forwards} forwards")
    # every bf16 linear outside the fused blocks takes linear_tc at any row
    # count (one f32-bias launch each): the patch embedding, and per decoder
    # layer the four projections of each attention and the FFN's two; the
    # objectness MLP runs in f32
    tc = 1 + 10 * svc.mcfg.n_decoder_layers
    if step_linears != (tc * len(imgs),) * 2 + (0,) or b8_linears != (tc, tc, 0):
        raise AssertionError(f"expected {tc} linear_tc calls a forward and none left on the "
                             f"f32 products, in model_step and in the B=8 forward, got "
                             f"{step_linears} and {b8_linears}")

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
    return svc, cfg, launches, {"model_step": step_linears[0], "forward B=8": b8_linears[0]}


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


def _signed_up_client(svc, cfg, tmp):
    """A client of the port's web app serving ``svc``, signed up and
    verified (logged in)."""
    from sod_tpu_torch.serving.app import create_app
    from sod_tpu_torch.serving.db import Database

    app = create_app(cfg=cfg, db=Database(":memory:"), load_model=False,
                     upload_dir=tmp, secret_key="smoke")
    app.inference = svc
    c = Client(app)
    st, r = c.request("POST", "/user_signup", json_body={
        "name": "smoke", "email": "smoke@example.com", "password": "pw", "phone": ""})
    if st != 200:
        raise AssertionError(f"/user_signup answered {st}: {r}")
    c.request("GET", r["verify_url"])
    return c


def requests_phase(svc, cfg):
    predict_requests(svc, cfg, "K1")
    phase(5, "3 /predict requests answered through the port's service")


def predict_requests(svc, cfg, kernel: str):
    """Three ``/predict`` requests through the web app with ``svc``; each
    must launch ``kernel`` (a key of ``launch_counts``) once per block."""
    import base64

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        c = _signed_up_client(svc, cfg, tmp)
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
# the vitg14reg-train-b8 cell's attention: DINOv2 ViT-g/14-reg at B=8, 518
# px (1 + 4 registers + 37 x 37 patches), 24 heads of 64
K2_VITG_SHAPE = (8, 24, 1374, 64)
# phase 6's (B, H, N), each at every head dim: one key, around the 64-row
# tile edge, two tiles and a bit, the train shape, the eval shape; then the
# ViT-g shape at its own head dim: phase 6's (B, H, N, d)
K2_SHAPES = tuple((2, 3, n) for n in (1, 63, 64, 65, 129)) + (
    K2_TRAIN_SHAPE[:3], K2_EVAL_SHAPE[:3])
K2_CASES = tuple((b, h, n, d) for b, h, n in K2_SHAPES for d in K2_HEAD_DIMS) + (
    K2_VITG_SHAPE,)


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
    {name: (kernel ms, plain ms)} at the train shape, under "vitg" the same
    at the ViT-g shape and, under "eval", the masked forward's at the eval
    shape with its bound on the valid keys."""
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

    for b, h, n, d in K2_CASES:
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
          f"{len(K2_CASES)} shapes: equal bits", flush=True)

    def timed(shape, times):
        """Forward and backward at ``shape`` (d 64), kernel and plain in turns."""
        q, k, v, do, _ = _k2_inputs(rng, shape)
        _, m, l = fa.flash_forward_cuda(q, k, v, 0.125)
        pairs = {"fwd": (lambda: fa.flash_forward_cuda(q, k, v, 0.125),
                         lambda: fa.flash_forward_reference(q, k, v, 0.125)),
                 "bwd": (lambda: fa.flash_backward_cuda(q, k, v, do, m, l, 0.125),
                         lambda: fa.flash_backward_reference(q, k, v, do, 0.125))}
        bounds = k2_bound(*shape)
        for name, (kern, plain) in pairs.items():
            # in turns on one card: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern, plain))
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"  {name} at B={shape[0]} H={shape[1]} N={shape[2]} d={shape[3]}: kernel "
                  f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms per call, bound "
                  f"{bounds[name]['bound_ms']:.4f} ms by {bounds[name]['bound_by']}",
                  flush=True)
        return q, k, v, do

    timings = {"vitg": {}}
    timed(K2_VITG_SHAPE, timings["vitg"])
    q, k, v, do = timed(K2_TRAIN_SHAPE, timings)

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
    del q, k, v, do, ql, kl, vl, out_l

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
             f"{list(K2_HEAD_DIMS)}, and at B={K2_VITG_SHAPE[0]} H={K2_VITG_SHAPE[1]} "
             f"N={K2_VITG_SHAPE[2]} d={K2_VITG_SHAPE[3]} (max_abs <= {K2_MAX_ABS}, rel_l2 <= "
             f"{K2_MAX_REL_L2}, corr > {K2_MIN_CORR}); two runs give equal bits")
    return worst, timings


# ---------------------------------------------------------------- phase 25
# The vitg14reg-train-b8 cell's model: SelfMask nq20 on DINOv2's ViT-g/14
# with registers (40 blocks, d 1536, 24 heads) at B=8 and 518 px, one step of
# make_train_step from random weights.  A step runs every block's qkv, proj,
# w12 and w3, the adapter and each decoder layer's ten linears through
# linear_tc; the patch embedding (K 588) alone stays on the f32 products
VITG_SIZE = 518


def vitg_train_check():
    """Phase 25: one training step of the vitg14reg-train-b8 cell's model.
    Returns {"tc": linear_tc calls, "f32": bf16 linears left on the f32
    products, "K2 fwd", "K2 bwd": launches, "ms": a step, "peak_gb"}."""
    import dataclasses

    import torch

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.models.vit import DINOV2_ARCH
    from sod_tpu_torch.ops import flash_attention as fa
    from sod_tpu_torch.ops import gemm as G
    from sod_tpu_torch.ops import layers as L
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    _release()
    live = load_config(CONFIG)
    cfg = dataclasses.replace(live, arch=DINOV2_ARCH, patch_size=14,
                              train_image_size=VITG_SIZE, eval_image_size=VITG_SIZE)
    mcfg = config_from(cfg)
    depth, n_dec = mcfg.vit.depth, mcfg.n_decoder_layers
    with torch.device("meta"):
        model = MaskFormer(mcfg)
    model = model.to_empty(device="cuda")
    model.load_state_dict(random_state_dict(model, cfg.seed))
    opt = build_optimizer(cfg, model.parameters(), n_iters_per_epoch=100)
    step = make_train_step(cfg, model, opt)
    batch = _to_cuda(synthetic_batch(np.random.default_rng(25), cfg.batch_size, VITG_SIZE,
                                     cfg.max_gt_masks))
    watch = ("encoder.blocks.0.attn.qkv.weight", f"encoder.blocks.{depth - 1}.mlp.w3.weight",
             "encoder.register_tokens", "linear_layer.weight", "query_embed")
    params = dict(model.named_parameters())
    before = {k: params[k].detach().clone() for k in watch}
    torch.cuda.reset_peak_memory_stats()
    L.tc_linears = L.f32_linears = G.launches = 0
    fa.fwd_launches = fa.bwd_launches = 0
    loss = float(step(batch)["loss"])
    torch.cuda.synchronize()
    got = {"tc": L.tc_linears, "f32": L.f32_linears, "f32bias": G.launches,
           "K2 fwd": fa.fwd_launches, "K2 bwd": fa.bwd_launches}
    moved = [k for k in watch if not torch.equal(params[k], before[k])]
    ms = _timed_steps(step, batch, 3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # four linears a block, the adapter, ten a decoder layer
    tc = 4 * depth + 1 + 10 * n_dec
    print(f"  B={cfg.batch_size} at {VITG_SIZE} px ({depth} blocks, {mcfg.vit.n_registers} "
          f"registers): loss {loss:.6g}; linear_tc calls {got['tc']} (f32-bias launches "
          f"{got['f32bias']}), left on f32 {got['f32']}; K2 {got['K2 fwd']}+{got['K2 bwd']}; "
          f"{len(moved)} of {len(watch)} watched tensors moved; {ms:.1f} ms a step, peak "
          f"{peak:.2f} GB [{CARD}]", flush=True)
    del model, opt, step, batch, params, before
    _release()
    if got != {"tc": tc, "f32": 1, "f32bias": tc, "K2 fwd": depth, "K2 bwd": depth}:
        raise AssertionError(f"expected {tc} linear_tc calls, the patch embedding alone on "
                             f"the f32 products and {depth} K2 launches each way, got {got}")
    if not (np.isfinite(loss) and len(moved) == len(watch)):
        raise AssertionError(f"the ViT-g step gave loss {loss} and moved only {moved}")
    phase(25, f"vitg14reg-train-b8's step: {tc} linear_tc calls, 1 left on f32, "
              f"{depth}+{depth} K2 launches, {ms:.1f} ms a step, peak {peak:.2f} GB")
    return dict(got, ms=ms, peak_gb=peak)


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
    groups = {"the port's kernels": ("flash_", "gemm_kernel", "gemm_s8_kernel", "attention_kernel",
                                     "attn_bwd_", "ln_rows_", "ln_bwd_", "reduce_partials_",
                                     "quant_rows_", "sweep_", "ub_band_", "ub_sum_"),
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


def k6_size_sweep():
    """Does K6 want a size threshold on this card (``sod_tpu``'s
    ``_MIN_PIXELS`` is a TPU's)?  K6 and its plain version at B = 1, 4, 16
    on 224 and 400 px canvases, every pixel valid: kernel eager and from a
    CUDA graph, plain eager, in turns."""
    import torch

    from sod_tpu_torch.ops import fsweep

    plain_wins = []
    for side in (224, 400):
        for b in (1, 4, 16):
            m = torch.rand(b, 2, side, side, device="cuda")
            g = (torch.rand(b, side, side, device="cuda") > 0.5).float()
            rv = torch.ones(b, side, dtype=torch.bool, device="cuda")
            cv = torch.ones(b, side, dtype=torch.bool, device="cuda")
            k_ms, p_ms = timed_pair(lambda: fsweep.fmax_tp_cnt(m, g, rv, cv),
                                    lambda: fsweep.fmax_tp_cnt_reference(m, g, rv, cv), 10)
            k_graph = graph_ms(lambda: fsweep.fmax_tp_cnt(m, g, rv, cv))
            print(f"  K6 size sweep B={b:<2d} {side} px: kernel {k_ms:.4f} ms eager, "
                  f"{k_graph:.4f} ms graph; plain {p_ms:.4f} ms ({p_ms / k_ms:.0f}x)",
                  flush=True)
            if p_ms < k_ms:
                plain_wins.append((b, side))
    print(f"  K6 size threshold: the plain version is faster at "
          f"{plain_wins or 'no size measured'}", flush=True)


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
        # uint8 validity and a width that is not a multiple of 4 (the scalar path)
        odd = (masks_t[:3, :, :, :397].contiguous(), gt_t[:3, :, :397].contiguous(),
               rowv[:3].to(torch.uint8), colv[:3, :397].to(torch.uint8).contiguous())
        diff_odd = sum(int((g != r).sum()) for g, r in zip(
            fsweep.fmax_tp_cnt(*odd), fsweep.fmax_tp_cnt_reference(*odd)))
        print(f"  K6 masks [3, 2, 400, 397], uint8 rowv / colv: {diff_odd} counts differ "
              f"(must be 0)", flush=True)
        if diff_odd:
            raise AssertionError("K6 counts differ from its plain version (scalar path)")
        before = fsweep.launches
        fsweep.fmax_tp_cnt(masks_t, gt_t, rowv, colv)
        if fsweep.launches != before + 1:
            raise AssertionError("K6 must count one launch per call")
        t16 = timed_pair(lambda: fsweep.fmax_tp_cnt(masks_t, gt_t, rowv, colv),
                         lambda: fsweep.fmax_tp_cnt_reference(masks_t, gt_t, rowv, colv), 20)
        g16 = graph_ms(lambda: fsweep.fmax_tp_cnt(masks_t, gt_t, rowv, colv))
        m4, g4, r4, c4 = masks_t[:4].contiguous(), gt_t[:4], rowv[:4], colv[:4]
        t4 = timed_pair(lambda: fsweep.fmax_tp_cnt(m4, g4, r4, c4),
                        lambda: fsweep.fmax_tp_cnt_reference(m4, g4, r4, c4), 20)
        g4_ms = graph_ms(lambda: fsweep.fmax_tp_cnt(m4, g4, r4, c4))
        print(f"  K6 B=16: kernel {t16[0]:.4f} ms eager, {g16:.4f} ms from a CUDA graph, "
              f"plain {t16[1]:.4f} ms; B=4: kernel {t4[0]:.4f} ms eager, {g4_ms:.4f} ms "
              f"graph, plain {t4[1]:.4f} ms per call", flush=True)
        out["K6"] = (diff6, *t16)
        out["K6 graph_ms"] = g16
        k6_size_sweep()

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
        # (6336 = 99 x 64: a 128-row tile ends half outside the rows)
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
        # K4 on 576 rows (9 x 64: a 128-row tile ends half outside the rows)
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


# the fused step's port kernels by piece (substrings of the profiler's kernel
# names: gemm_kernel's last template argument is its layout, 0 NT, 1 NN, 2 TN)
FUSED_STEP_WATCH = {
    "gemm_kernel NT (forward, recomputes)": ("e, 0>(",),
    "gemm_kernel NN (input gradients)": ("e, 1>(",),
    "gemm_kernel TN (weight gradients)": ("e, 2>(",),
    "ln_bwd_kernel": ("ln_bwd_kernel",), "ln_rows_kernel": ("ln_rows_kernel",),
    "reduce_partials": ("reduce_partials",), "attention forward": ("attention_kernel",),
    "attention backward (dq, dk/dv)": ("attn_bwd_",)}


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
    prof = profile_steps(steps["use_fused_train"], batch, 3, times["use_fused_train"],
                         watch=FUSED_STEP_WATCH)
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
MASKGEN_IMAGES = 32                      # two batches of the generator's 16
MASKGEN_FEATURE_REL, MASKGEN_LABEL_AGREEMENT = 1e-3, 0.98


def write_maskgen_images(root: str, n: int, seed: int = 16) -> list:
    """JPEGs of 150-400 px: a bright ellipse on a textured dark ground."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(150, 401, 2))
        yy, xx = np.mgrid[:h, :w]
        tex = 40 + 25 * np.sin(xx / rng.uniform(3, 9)) * np.cos(yy / rng.uniform(3, 9))
        img = np.repeat(tex[..., None], 3, 2) + rng.normal(0, 6, (h, w, 3))
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.3) * h, rng.uniform(0.15, 0.3) * w
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        img[inside] = rng.uniform(150, 240, 3) + rng.normal(0, 6, (int(inside.sum()), 3))
        paths.append(os.path.join(root, f"mg_{i:03d}.jpg"))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(paths[-1], quality=92)
    return paths


def _label_agreement(a, b, k: int) -> float:
    """Share of nodes with equal labels under the best permutation of b's."""
    import itertools

    return max(float(np.mean(np.asarray(p)[b] == a)) for p in itertools.permutations(range(k)))


def maskgen_check():
    """Phase 16: pseudo-mask generation (``MaskGenerator``, the
    ``generate_masks`` CLI) at the live config's full width on the card."""
    import torch

    from sod_tpu_torch.cli import generate_masks
    from sod_tpu_torch.data.clusterings import _build_lsym
    from sod_tpu_torch.data.custom import CustomDataset
    from sod_tpu_torch.data.mask_generator import MaskGenerator, f32_math
    from sod_tpu_torch.ops import rle

    # the generator must turn TF32 off itself: the card's defaults around it
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    tmp = tempfile.mkdtemp(prefix="sod_maskgen_")
    try:
        paths = write_maskgen_images(tmp, MASKGEN_IMAGES)
        gen = MaskGenerator(device="cuda")             # mocov2, swav, dino; spectral; k 2 3 4
        gen(paths[:gen.batch_size])                    # warm-up: cuDNN, the allocator
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        masks = gen(paths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        bad = [name for name, enc in masks.items()
               if rle.decode(enc).shape != (224, 224) or not 0 < rle.decode(enc).sum() < 224 * 224]
        print(f"  MaskGenerator({gen.feature_types}, {gen.cluster_type}, k {gen.cluster_sizes}, "
              f"scale {gen.scale_factor}, B {gen.batch_size}) on {len(paths)} images: "
              f"{len(masks)} RLEs, {len(bad)} empty, full or not 224 x 224; "
              f"{len(paths) / wall:.2f} img/s ({wall:.3f} s); the port's kernel launches "
              f"{ {k: v for k, v in counts.items() if v} or 'none (plain PyTorch)'}", flush=True)
        if len(masks) != len(paths) or bad:
            raise AssertionError(f"maskgen: bad or missing masks {bad}")

        # device time per batch of extract and cluster per backbone (batch 2)
        ds = CustomDataset(paths[16:32], image_size=224, square=True, raw_uint8=True)
        u8 = torch.from_numpy(np.stack([ds[i]["image_u8"] for i in range(16)])).cuda()
        busy = 0.0
        with torch.inference_mode(), f32_math():
            for ft in gen.feature_types:
                e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                e[0].record()
                f = gen.features(ft, u8)
                e[1].record()
                gen.cluster(f)
                e[2].record()
                torch.cuda.synchronize()
                ext, clu = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
                busy += ext + clu
                print(f"  {ft}: features {tuple(f.shape)}, extract {ext:.3f} ms, cluster "
                      f"{clu:.3f} ms per batch of 16 (CUDA events)", flush=True)
                del f
        print(f"  per batch: {busy:.3f} ms of the stream's time (events; launch gaps "
              f"included) against {wall * 1e3 / 2:.3f} ms of host clock in the timed call",
              flush=True)

        # the card against the port on the CPU: the first 4 images of a batch
        u4 = u8[:4]
        with torch.inference_mode():
            for ft in gen.feature_types:
                cpu = MaskGenerator(device="cpu", params={ft: {
                    k: v.cpu() for k, v in gen._get_params(ft).state_dict().items()}})
                with f32_math():
                    f_card = gen.features(ft, u4)
                    lab_card = gen.cluster(f_card)
                    n = f_card.shape[1] * f_card.shape[2]
                    lab_dense = gen.cluster(f_card, eigh_max_n=n)
                    lam = torch.linalg.eigvalsh(_build_lsym(f_card.reshape(4, n, -1)).double())
                f_cpu = cpu.features(ft, u4.cpu())
                rel = float((f_card.cpu() - f_cpu).abs().max() / f_cpu.abs().max())
                lab_cpu = cpu.cluster(f_card.cpu())
                line = f"  {ft}: features card vs CPU max rel {rel:.3g} (bound {MASKGEN_FEATURE_REL})"
                ok = rel <= MASKGEN_FEATURE_REL
                for k in gen.cluster_sizes:
                    a, c, d = (x[k].reshape(4, -1).cpu().numpy() for x in (lab_card, lab_cpu, lab_dense))
                    agree = np.mean([_label_agreement(a[i], c[i], k) for i in range(4)])
                    dense = np.mean([_label_agreement(a[i], d[i], k) for i in range(4)])
                    gap = float((lam[:, 1:k + 1] - lam[:, :k]).min())
                    line += (f"; k={k}: card vs CPU {agree:.4f} (bound {MASKGEN_LABEL_AGREEMENT}), "
                             f"subspace vs dense eigh {dense:.4f}, smallest gap among the first "
                             f"{k + 1} eigenvalues {gap:.3g}")
                    ok = ok and agree >= MASKGEN_LABEL_AGREEMENT
                print(line + (" -> ok" if ok else " -> FAIL"), flush=True)
                if not ok:
                    raise AssertionError(f"maskgen {ft}: the card disagrees with the CPU")
                del f_card, lab_card, lab_dense, lam

        # torch.profiler over one batch: the idle share is the kernels' busy
        # time against the batch's unprofiled time
        gen16 = paths[:16]
        t0 = time.perf_counter()
        gen(gen16)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_steps(gen, gen16, 1, batch_ms, unit="batch")

        # the CLI on the card by default
        out = os.path.join(tmp, "pseudo_masks.json")
        cli_masks = generate_masks.main(["--p_images", os.path.join(tmp, "*.jpg"), "--fp", out])
        same = sum(cli_masks.get(k) == v for k, v in masks.items())
        print(f"  cli.generate_masks: {len(cli_masks)} masks in {out}, {same} equal to the "
              f"generator's", flush=True)
        if set(cli_masks) != set(masks):
            raise AssertionError("generate_masks CLI: missing masks")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    idle = prof["idle_share"]
    phase(16, f"pseudo-mask generation at full width on the card ({len(paths) / wall:.2f} "
              f"img/s, idle share {'not measured' if idle is None else f'{idle:.3f}'}), the "
              f"card within the bounds of the port on the CPU")


SERVE_N = 785                            # tokens of a 224 px image at patch 8
K8_MAX_LAUNCHES = 6                      # kernel launches of one K8 block call, at most
S8 = dict(route="cuda", source="sod_tpu_torch/csrc/vit_block.cuh",
          replaces="sod_tpu/ops/fused_block_int8.py:129")
# K8's four s8 products alone at B=8 (8 x 896 = 7168 rows), d 384, hidden
# 1536: (form, N, K, the bf16 form of the same product)
S8_ROWS = 7168
S8_FORMS = (("qkv", 1152, 384, "bias_bf16"), ("proj", 384, 384, "res_f32"),
            ("fc1", 1536, 384, "gelu_bf16"), ("fc2", 384, 1536, "res_bf16"))


def s8_form_bound(form: str, m: int, n: int, k: int) -> dict:
    """The least time the card could take for one of K8's s8 products: 2 m
    n k operations at the s8 peak, against the rows it quantises (bf16 for
    QKV and proj, f32 for fc1 and fc2), the int8 weight, its f32 scales and
    bias, the LN parameters, the residual, the output and fc1's row maxima
    (written by fc1, read by fc2), each moved once."""
    a_bytes = 2 if form in ("qkv", "proj") else 4
    res_bytes = {"proj": 2, "fc2": 4}.get(form, 0)
    out_bytes = 2 if form in ("qkv", "fc2") else 4
    part = m * (n if form == "fc1" else k) // 64 * 4 if form in ("fc1", "fc2") else 0
    n_bytes = (m * k * a_bytes + n * k + 8 * n + (8 * k if form in ("qkv", "fc1") else 0)
               + m * n * (res_bytes + out_bytes) + part)
    return roofline(2.0 * m * n * k, n_bytes, PEAK_INT8_OPS)


def block_launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches, from a profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def s8_forms_check(rng):
    """Phase 14's four s8 products alone at ``S8_ROWS`` rows; returns {form:
    (max_abs, ms, plain_ms, bound, int_mm_ms)}."""
    import torch

    from sod_tpu_torch.ops import fused_block_int8 as fq
    from sod_tpu_torch.ops import gemm as G

    def mk(shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale).to(
            device="cuda", dtype=dtype)

    m, report, part = S8_ROWS, {}, None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x1 = mk((m, 384), 2.0)
    for form, n, k, bf16_epi in S8_FORMS:
        a = mk((m, k), 1.0, fq.S8_FORMS[form][0])
        w32 = mk((n, k), 0.02)
        wq, ws = fq.quantize_weight(w32)
        bias = mk((n,), 0.02)
        kw = {}
        if form in ("qkv", "fc1"):
            kw["ln"] = (1 + mk((k,), 0.1), mk((k,), 0.1))
        if form == "proj":
            kw["res"] = mk((m, n), 1.0, torch.bfloat16)
        if form == "fc2":
            a = fq.qgemm_reference("fc1", x1, *fq.quantize_weight(mk((k, 384), 0.05)),
                                   mk((k,), 0.02), ln=(1 + mk((384,), 0.1), mk((384,), 0.1)))[0]
            part = a.abs().reshape(m, -1, fq.PART_COLS).amax(-1)
            kw.update(res=x1, part=part)
        sk, sr = {}, {}
        before = fq.form_launches
        got, got_part = fq.qgemm(form, a, wq, ws, bias, scratch=sk, **kw)
        again = fq.qgemm(form, a, wq, ws, bias, **kw)[0]
        torch.cuda.synchronize()
        if fq.form_launches - before != 2:
            raise AssertionError(f"qgemm counted {fq.form_launches - before} launches for 2 calls")
        ref, ref_part = fq.qgemm_reference(form, a, wq, ws, bias, scratch=sr, **kw)
        flips = int((sk["q"] != sr["q"]).sum())
        max_abs = float((got.float() - ref.float()).abs().max())
        # LayerNorm's sums run in another order in the plain version, so the
        # LN forms may flip a code at a .5 boundary (and fc1's tanh is the
        # card's, not torch's): their outputs within K8's two bf16 ulps at
        # the output's magnitude.  proj and fc2 quantise identical values
        # with the same rounded steps: code for code and bit for bit
        limit = K8_MAX_ULPS * bf16_ulp_at(ref) if "ln" in kw else 0.0
        share = flips / sk["q"].numel()
        ok = (bool(torch.isfinite(got).all()) and max_abs <= limit and torch.equal(got, again)
              and share <= (K8_FIRST_FLIPS if "ln" in kw else 0.0))
        if form == "fc1":
            ok = ok and float((got_part - ref_part).abs().max()) <= limit
        elem = fq.S8_ROW_ELEM[form]
        plan, mirror = fq.kernel_plan(m, n, k, elem), fq.s8_plan(m, n, k, elem, sms)
        ok = ok and plan == mirror
        qa = sk["q"]
        w16, b16 = w32.to(torch.bfloat16), bias.to(torch.bfloat16)
        a16 = a.to(torch.float32 if bf16_epi == "gelu_bf16" else torch.bfloat16)
        ln16 = tuple(t.to(torch.bfloat16) for t in kw["ln"]) if "ln" in kw else None
        res16 = None
        if form == "proj":
            res16 = kw["res"]
        elif form == "fc2":
            res16 = x1
        kern = lambda: fq.qgemm(form, a, wq, ws, bias, **kw)             # noqa: E731
        plain = lambda: fq.qgemm_reference(form, a, wq, ws, bias, **kw)  # noqa: E731
        lib = lambda: torch._int_mm(qa, wq.t())                          # noqa: E731
        bf16 = lambda: G.gemm(a16, w16, b16, bf16_epi, ln=ln16, res=res16)  # noqa: E731
        # from CUDA graphs, in turns: plain, kernel, _int_mm, bf16, bf16,
        # _int_mm, kernel, plain
        t = [graph_ms(f, 5 if f is plain else 20) for f in (plain, kern, lib, bf16, bf16, lib,
                                                            kern, plain)]
        ms, plain_ms, lib_ms, bf16_ms = ((t[1] + t[6]) / 2, (t[0] + t[7]) / 2,
                                         (t[2] + t[5]) / 2, (t[3] + t[4]) / 2)
        bound = s8_form_bound(form, m, n, k)
        print(f"  s8 {form:4s} M {m} N {n:4d} K {k:4d} (plan {plan}, mirror {mirror}): max_abs "
              f"{max_abs:.4g} (<= {limit:.4g}), codes that differ {flips} ({share:.2e}), runs "
              f"equal; kernel {ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
              f"bf16 form {bf16_ms:.4f} ms ({ms / bf16_ms:.2f}x), plain {plain_ms:.3f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, {ms / bound['bound_ms']:.2f}x) "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"the s8 {form} product disagrees with its plain version, "
                                 f"between runs, or its plan with the mirror")
        report[form] = (max_abs, ms, plain_ms, bound, lib_ms)
    return report


def quantized(blk32):
    """The int8 record of an f32 ``Block`` on the card."""
    from sod_tpu_torch.ops.fused_block_int8 import quantize_vit_blocks

    state = {f"blocks.0.{k}": v for k, v in blk32.state_dict().items()}
    return quantize_vit_blocks(state, prefix="blocks.")[0]


def int8_kernel_check():
    """Phase 14: K8 against its plain version; returns the worst max_abs,
    {B: (K8 ms, plain ms, K1 ms)}, K8's bound at B=8 and the s8 products'
    report (``s8_forms_check``)."""
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

        # the kernel launches of one block call: the chain's length
        bq = quantized(make_block(rng, d, h, True, torch.float32))
        n_launch = block_launches(lambda: fq.fused_vit_block_int8(x, bq, h, SERVE_N))
        print(f"  one K8 block call launches {n_launch} kernels (at most {K8_MAX_LAUNCHES}: "
              f"four s8 products and the attention)", flush=True)
        if n_launch > K8_MAX_LAUNCHES:
            raise AssertionError(f"K8 launched {n_launch} kernels a block")

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

        forms = s8_forms_check(rng)

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
              f"{K8_LATER_FLIPS} after it), {n_launch} launches a block; quantiser and s8 "
              f"product alone exact; its four s8 products alone match their plain versions")
    return worst, timings, bound, forms


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
        print("  the int8 B=8 forward:", flush=True)
        busy8 = profile_steps(lambda _: svc.forward_u8(batch), None, 10, lat["B=8"][0],
                              unit="forward", watch={
                                  "K8 (s8 products with their quantisers, attention)":
                                  ("gemm_s8_kernel", "attention_kernel"),
                                  "of it the s8 products": ("gemm_s8_kernel",)})["busy_ms"]
        print("  the bf16 B=8 forward:", flush=True)
        busy16 = profile_steps(lambda _: svc16.forward_u8(batch), None, 10, lat["B=8"][1],
                               unit="forward", watch={"K1": ("gemm_kernel", "attention_kernel")}
                               )["busy_ms"]
        print(f"  device busy per B=8 forward: int8 {busy8} ms, bf16 {busy16} ms", flush=True)

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


# --------------------------------------------------- refinement (phase 17)
REFINE_SIZES = ((320, 240), (1024, 768), (4000, 3000))   # (w, h); the last a phone photo
# the card's solve against the same solve on the CPU on one grid: the soft
# mask lies in [0, 1]; the splat's atomics and the dot products sum in
# another order than the CPU's, 25 CG iterations carry that f32 noise
# (H100 run: max_abs 3.3e-6 at 320x240, 1.6e-5 at 1024x768, 1.5e-5 at
# 4000x3000)
REFINE_SOFT_TOL = 1e-4


def refine_image(rng, w: int, h: int) -> np.ndarray:
    """A synthetic photo: a bright ellipse on a textured darker ground."""
    yy, xx = np.ogrid[:h, :w]
    img = rng.integers(0, 16, (h, w, 3), dtype=np.uint8)
    img += (40 + 25 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.uint8)[..., None]
    inside = ((yy - 0.5 * h) / (0.3 * h)) ** 2 + ((xx - 0.45 * w) / (0.25 * w)) ** 2 <= 1
    img[inside] += np.array([150, 120, 90], np.uint8)
    return img


def _jpeg(img: np.ndarray):
    """A photo as a phone uploads it: JPEG bytes, and the pixels they decode
    to (what the service sees)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _decode_png(b64: str) -> np.ndarray:
    import base64

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def refine_check(svc, cfg) -> dict:
    """``/predict?refine=1`` through the port's app with the K1 service, at
    each size of ``REFINE_SIZES``; then, on the mask each request returned,
    the refinement's pieces one by one (host grid, device solve, host
    post-step, PNG encode), the card's solve against the CPU's; then
    ``cli/refine`` and ``cli/predict --refine`` once each."""
    import torch
    from PIL import Image

    from sod_tpu_torch.cli import predict as predict_cli
    from sod_tpu_torch.cli import refine as refine_cli
    from sod_tpu_torch.ops import fused_block as fb
    from sod_tpu_torch.postprocess import bilateral_solver as bs
    from sod_tpu_torch.serving.inference import _b64_png

    rng = np.random.default_rng(17)
    depth = svc.mcfg.vit.depth
    split, worst = {}, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        c = _signed_up_client(svc, cfg, tmp)
        for w, h in REFINE_SIZES:
            data, img = _jpeg(refine_image(rng, w, h))
            before = fb.launches
            t0 = time.perf_counter()
            st, r = c.request("POST", "/predict?refine=1", files={"image": ("photo.jpg", data)})
            req_ms = (time.perf_counter() - t0) * 1e3
            if st != 200 or not r.get("success"):
                raise AssertionError(f"/predict?refine=1 answered {st}: {str(r)[:300]}")
            if fb.launches - before != depth:
                raise AssertionError(f"/predict?refine=1 launched K1 "
                                     f"{fb.launches - before} times, not {depth}")
            got = {k: _decode_png(r[k]) for k in ("mask", "refined_mask", "binary_mask")}
            for k, a in got.items():
                if a.shape != (h, w):
                    raise AssertionError(f"{k} {a.shape} for a {w}x{h} upload")
            if not set(np.unique(got["binary_mask"])) <= {0, 255}:
                raise AssertionError("binary_mask is not binary")

            # the pieces, on the mask this request returned
            mask = got["mask"].astype(np.float32) / 255.0
            t0 = time.perf_counter()
            t, conf, idx, nbrs, nv = bs.solver_inputs(img, mask)
            grid_ms = (time.perf_counter() - t0) * 1e3
            on_card = [torch.as_tensor(a, device="cuda") for a in (t, conf, idx, nbrs)]
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            soft_d = bs._solve_device(*on_card, nvertices=nv, device="cuda")
            e1.record()
            torch.cuda.synchronize()
            solve_ms = e0.elapsed_time(e1)
            soft_d = soft_d[:h * w].cpu().numpy().reshape(h, w)
            soft_c = bs._solve_device(t, conf, idx, nbrs, nvertices=nv,
                                      device="cpu")[:h * w].numpy().reshape(h, w)
            err = float(np.abs(soft_d - soft_c).max())
            worst = max(worst, err)
            t0 = time.perf_counter()
            binary = bs.fill_holes_and_select(soft_d > 0.5)
            post_ms = (time.perf_counter() - t0) * 1e3
            binary_c = bs.fill_holes_and_select(soft_c > 0.5)
            off_band = np.abs(soft_c - 0.5) > REFINE_SOFT_TOL
            n_diff = int((binary != binary_c)[off_band].sum())
            soft_u8 = (np.clip(soft_d, 0, 1) * 255).astype(np.uint8)
            t0 = time.perf_counter()
            _b64_png(Image.fromarray(soft_u8))
            _b64_png(Image.fromarray(binary.astype(np.uint8) * 255))
            png_ms = (time.perf_counter() - t0) * 1e3
            served = int(np.abs(got["refined_mask"].astype(int) - soft_u8.astype(int)).max())
            print(f"  /predict?refine=1 {w}x{h}: 200 in {req_ms:.1f} ms, K1 {depth} launches; "
                  f"{nv} vertices (padded), {t.size} pixels (padded); host grid "
                  f"{grid_ms:.1f} ms, device solve {solve_ms:.3f} ms (events), "
                  f"fill_holes_and_select {post_ms:.1f} ms, PNG encode {png_ms:.1f} ms; "
                  f"card vs CPU soft max_abs {err:.3g}, binary differs off the "
                  f"{REFINE_SOFT_TOL} band at {n_diff} pixels; served refined mask vs "
                  f"this solve {served} levels", flush=True)
            if not err <= REFINE_SOFT_TOL or n_diff or served > 1:
                raise AssertionError(f"refinement at {w}x{h}: card vs CPU {err:.3g} (bound "
                                     f"{REFINE_SOFT_TOL}), {n_diff} binary pixels, served "
                                     f"{served} levels")
            split[f"{w}x{h}"] = dict(request_ms=req_ms, grid_ms=grid_ms, solve_ms=solve_ms,
                                     post_ms=post_ms, png_ms=png_ms, max_abs_err=err)

        # cli/refine on the first size's image and mask
        w, h = REFINE_SIZES[0]
        data, img = _jpeg(refine_image(np.random.default_rng(18), w, h))
        Image.fromarray(img).save(os.path.join(tmp, "photo.png"))
        _, mask = c.request("POST", "/predict", files={"image": ("p.jpg", data)})
        Image.fromarray(_decode_png(mask["mask"])).save(os.path.join(tmp, "mask.png"))
        soft_p, bin_p = os.path.join(tmp, "soft.png"), os.path.join(tmp, "binary.png")
        refine_cli.main(["--image", os.path.join(tmp, "photo.png"), "--mask",
                         os.path.join(tmp, "mask.png"), "--out-soft", soft_p,
                         "--out-binary", bin_p, "--device", "cuda"])
        for p in (soft_p, bin_p):
            if Image.open(p).size != (w, h):
                raise AssertionError(f"cli.refine wrote {Image.open(p).size} for {w}x{h}")
        # cli/predict --refine over two images in one batch
        for i, (ww, hh) in enumerate(((320, 240), (256, 300))):
            os.makedirs(os.path.join(tmp, "in"), exist_ok=True)
            Image.fromarray(refine_image(rng, ww, hh)).save(os.path.join(tmp, "in", f"r{i}.png"))
        out = os.path.join(tmp, "out")
        before = fb.launches
        predict_cli.main(["--p_images", os.path.join(tmp, "in", "*.png"), "--out", out,
                          "--config", CONFIG, "--batch_size", "2", "--refine",
                          "--device", "cuda"])
        names = sorted(os.listdir(out))
        if names != ["r0_mask.png", "r0_refined.png", "r1_mask.png", "r1_refined.png"]:
            raise AssertionError(f"cli.predict --refine wrote {names}")
        if fb.launches - before != depth:                 # one forward of a batch of 2
            raise AssertionError(f"cli.predict --refine launched K1 "
                                 f"{fb.launches - before} times")
        for i, (ww, hh) in enumerate(((320, 240), (256, 300))):
            if Image.open(os.path.join(out, f"r{i}_refined.png")).size != (ww, hh):
                raise AssertionError("cli.predict --refine: a refined mask of another size")
        print(f"  cli.refine wrote {w}x{h} soft and binary PNGs; cli.predict --refine wrote "
              f"{names} with {fb.launches - before} K1 launches", flush=True)
    phase(17, f"refinement: /predict?refine=1 at {', '.join(split)} answered with "
              f"refined_mask and binary_mask at the upload's size, {depth} K1 launches "
              f"each; the card's solve within {worst:.3g} of the CPU's (bound "
              f"{REFINE_SOFT_TOL}); cli.refine and cli.predict --refine")
    return split


# --------------------------------------------------- serving pool (phase 18)
POOL_WORKERS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _uses_card(pid: int) -> bool:
    """Whether process ``pid`` holds the card: a CUDA context keeps the
    ``/dev/nvidia*`` device files open; importing torch opens none."""
    fds = f"/proc/{pid}/fd"
    for fd in os.listdir(fds):
        with contextlib.suppress(OSError):
            if os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia"):
                return True
    return False


def _exited(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except OSError:
        return True


def pool_check(svc, cfg) -> dict:
    """``python -m sod_tpu_torch.serving.app --workers 2 --device cuda`` as
    a subprocess on a file database: both workers answer, a user signs up,
    six ``/predict`` (two with ``refine=1``) come back with masks
    byte-equal to the in-process service's (``svc``, the same seeded
    weights on the card); the broker holds the card and no worker does;
    SIGTERM frees the port and ends every worker."""
    import signal
    import socket
    import urllib.request

    rng = np.random.default_rng(19)
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        log_path = os.path.join(tmp, "pool.log")
        env = dict(os.environ, SOD_DB_PATH=os.path.join(tmp, "pool.db"))
        env.pop("SOD_DB_URL", None)
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "sod_tpu_torch.serving.app", "--workers",
                 str(POOL_WORKERS), "--port", str(port), "--device", "cuda",
                 "--config", CONFIG],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=log,
                stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{port}"
        opener = urllib.request.build_opener(urllib.request.HTTPCookieProcessor())

        def req(path, data=None, headers=None, timeout=120):
            r = urllib.request.Request(base + path, data=data, headers=headers or {})
            with opener.open(r, timeout=timeout) as resp:
                return json.loads(resp.read())

        def multipart(data):
            bd = "smokepool"
            body = (f"--{bd}\r\nContent-Disposition: form-data; name=\"image\"; "
                    f"filename=\"p.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n").encode() + \
                data + f"\r\n--{bd}--\r\n".encode()
            return body, {"Content-Type": f"multipart/form-data; boundary={bd}"}

        try:
            t0 = time.perf_counter()
            workers, broker_pid = set(), None
            while len(workers) < POOL_WORKERS:
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    raise AssertionError(f"the pool did not come up: exit {proc.poll()}")
                try:
                    info = req("/test_connection", timeout=5)
                    workers.add(info["pid"])
                    broker_pid = info["model"]["broker_pid"]
                except (OSError, ValueError, KeyError):
                    time.sleep(0.5)
            boot_s = time.perf_counter() - t0
            if broker_pid != proc.pid or proc.pid in workers:
                raise AssertionError(f"broker pid {broker_pid}, workers {workers}, "
                                     f"server {proc.pid}")
            r = req("/user_signup", data=json.dumps({
                "name": "pool", "email": "pool@example.com", "password": "pw",
                "phone": ""}).encode(), headers={"Content-Type": "application/json"})
            if not req(r["verify_url"]).get("success"):
                raise AssertionError("the verify link failed on the pool")
            ms, refine_levels = [], 0
            for i in range(6):
                refine = i in (1, 4)
                w, h = ((320, 240), (480, 360), (224, 224))[i % 3]
                data, _ = _jpeg(refine_image(rng, w, h))
                body, headers = multipart(data)
                t1 = time.perf_counter()
                r = req("/predict" + ("?refine=1" if refine else ""), data=body,
                        headers=headers)
                ms.append((time.perf_counter() - t1) * 1e3)
                want = svc.predict(data, refine=refine)
                if not r.get("success") or r["mask"] != want["mask"]:
                    raise AssertionError(f"pool /predict {i}: mask differs from the "
                                         f"in-process service's")
                if r["objectness_scores"] != want["objectness_scores"]:
                    raise AssertionError(f"pool /predict {i}: objectness differs")
                if refine:
                    for k in ("refined_mask", "binary_mask"):
                        if _decode_png(r[k]).shape != (h, w):
                            raise AssertionError(f"pool {k} of another size")
                    # the worker solved on the CPU, the in-process service on the card
                    refine_levels = max(refine_levels, int(np.abs(
                        _decode_png(r["refined_mask"]).astype(int)
                        - _decode_png(want["refined_mask"]).astype(int)).max()))
            if refine_levels > 1:
                raise AssertionError(f"pool refined mask {refine_levels} levels from the "
                                     f"card's")
            smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.split()
            listed = {int(p) for p in smi if p.strip().isdigit()}
            holders = {pid: _uses_card(pid) for pid in [proc.pid, *sorted(workers)]}
            print(f"  pool up in {boot_s:.1f} s: broker {proc.pid}, workers "
                  f"{sorted(workers)}; nvidia-smi compute apps {sorted(listed)}; "
                  f"/dev/nvidia* open: {holders}", flush=True)
            if not holders[proc.pid] or any(holders[p] for p in workers):
                raise AssertionError(f"the card is held by {holders}: the broker alone "
                                     f"must hold it")
            if proc.pid in listed:
                if listed & workers:
                    raise AssertionError(f"nvidia-smi lists workers {listed & workers}")
            else:
                print("  (nvidia-smi lists the pids of another pid namespace: the "
                      "/dev/nvidia* check above decides)", flush=True)
            print(f"  pool /predict ms (6 requests, refine at 2 and 5): "
                  + ", ".join(f"{m:.1f}" for m in ms) + f"; refined masks within "
                  f"{refine_levels} level of the card's", flush=True)
        except BaseException:
            with open(log_path) as f:
                print("  pool log:\n" + f.read()[-4000:], flush=True)
            raise
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(timeout=30)
        deadline = time.perf_counter() + 30
        while not all(_exited(p) for p in workers) and time.perf_counter() < deadline:
            time.sleep(0.2)
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("0.0.0.0", port))               # raises while anything listens
            s.listen(1)
        alive = [p for p in workers if not _exited(p)]
        if alive or rc != 0:
            raise AssertionError(f"after SIGTERM: server exit {rc}, workers alive {alive}")
    phase(18, f"serving pool: {POOL_WORKERS} workers behind the broker answered signup and "
              f"6 /predict (2 refined) with the in-process masks, median "
              f"{float(np.median(ms)):.1f} ms; the broker alone holds the card; SIGTERM "
              f"freed port {port} and ended every worker")
    return {"boot_s": boot_s, "predict_ms": ms}


# --------------------------------------------- smoke and export CLIs (phase 19)
def tools_check(svc, cfg) -> None:
    """``cli.smoke --device cuda`` passes; ``cli.export`` of a checkpoint of
    the Trainer's format holding the service's weights gives the reference's
    file, which a new service loads to the same masks."""
    import torch

    from sod_tpu_torch.cli import export, smoke
    from sod_tpu_torch.models.maskformer import MaskFormer, random_state_dict
    from sod_tpu_torch.serving.inference import SelfMaskInference
    from sod_tpu_torch.train.checkpoints import save_checkpoint

    rc = smoke.main(["--config", CONFIG, "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"cli.smoke --device cuda exited {rc}")
    with tempfile.TemporaryDirectory() as tmp:
        model = MaskFormer(svc.mcfg)
        model.load_state_dict(random_state_dict(model, cfg.seed))
        ckpt, out = os.path.join(tmp, "latest_model.pt"), os.path.join(tmp, "export.pt")
        save_checkpoint(ckpt, model, epoch=2, n_iters=20)
        export.main(["--ckpt", ckpt, "--out", out])
        payload = torch.load(out, map_location="cpu", weights_only=True)
        sd = model.state_dict()
        if (payload.get("n_epochs"), payload.get("n_iters")) != (2, 20) or \
                set(payload["model"]) != set(sd) or \
                not all(torch.equal(payload["model"][k], v) for k, v in sd.items()):
            raise AssertionError("cli.export did not round-trip the checkpoint")
        svc2 = SelfMaskInference(cfg=cfg.replace(micro_batch=False), device="cuda",
                                 model_path=out, warmup=False)
        img = refine_image(np.random.default_rng(20), 224, 224)
        (m1, o1), (m2, o2) = svc.model_step(img), svc2.model_step(img)
        del svc2
        if not (np.array_equal(m1, m2) and np.array_equal(o1, o2)):
            raise AssertionError("the exported weights serve other masks")
    phase(19, "cli.smoke --device cuda passed; cli.export round-tripped a checkpoint "
              f"({len(sd)} tensors, epochs and iterations kept) and a service on it "
              "answers the in-process masks")


# ------------------------------ model options off the live config (phase 20)
# the ResNet-50 service (bf16) against the same weights' f32 forward (TF32
# off) and against its own bf16 forward on the CPU (cuDNN's bf16
# convolutions against the CPU's), on the last layer's masks of every query
# and on objectness: bf16 rounding through 53 BatchNorms and 16 blocks.  The
# random weights' mask logits are large, so most sigmoids saturate and a
# pixel whose logit lies near 0 can move far: held are the mean gap and the
# share of pixels whose binarised (> 0.5) masks differ (first H100 run, bf16
# vs f32: mean 1.1e-5, one pixel's gap 0.96, 1.0e-5 of the pixels
# differing binarised, objectness 1.6e-3; card vs CPU: 0, 0, 1.9e-3)
RESNET_MASK_MEAN, RESNET_MASK_FLIPS, RESNET_OBJ_TOL = 0.02, 1e-3, 0.01
# one f32 ResNet train step at a small shape (B=2, 64 px), card (TF32 off)
# against the CPU: f32 sums in another order, amplified by batch-statistics
# BatchNorm; Adam's first step turns small gradient elements into
# sign-sized updates (first H100 run: loss rel 1.7e-6, grad_norm rel 6.1e-4,
# update corr 0.9968, buffers rel 1.2e-5)
OPT_LOSS_RTOL, OPT_GNORM_RTOL, OPT_MIN_UPDATE_CORR, OPT_BUF_RTOL = 1e-3, 2e-2, 0.98, 1e-3
# the Hungarian branch's losses, card against CPU (f32; first H100 run: 1.05e-7)
HUNGARIAN_RTOL = 1e-5
# vit_n_last_cls through K2 against the plain softmax (bf16 ViT-S/8, 12
# blocks): f32 sums in another order flip single bf16 roundings, which the
# blocks carry on (first H100 run: max_abs 0.047, rel L2 0.0106, corr
# 0.99994)
HELPER_REL_L2, HELPER_MIN_CORR = 3e-2, 0.999


def _mask_gaps(a, b):
    """mean |a - b| of the last layer's masks, the share of their pixels
    whose binarised masks differ, max |a - b| of its objectness (dicts of
    the forward)."""
    ma, mb = a["mask_pred"][:, -1].float(), b["mask_pred"][:, -1].float()
    do = (a["objectness"][:, -1].float() - b["objectness"][:, -1].float()).abs()
    return (float((ma - mb).abs().mean()), float(((ma > 0.5) != (mb > 0.5)).float().mean()),
            float(do.max()))


def _gaps_ok(gaps) -> bool:
    return (gaps[0] <= RESNET_MASK_MEAN and gaps[1] <= RESNET_MASK_FLIPS
            and gaps[2] <= RESNET_OBJ_TOL)


def resnet_service_check(cfg):
    """The service with ``arch: resnet50`` in bf16 at B=1 and B=8: agreement
    with the f32 forward of the same weights and with the bf16 forward on
    the CPU; forward ms."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, random_state_dict
    from sod_tpu_torch.serving.inference import SelfMaskInference

    cfg_r = dataclasses.replace(cfg, arch="resnet50", micro_batch=False)
    svc = SelfMaskInference(cfg=cfg_r, device="cuda")
    svc32 = SelfMaskInference(cfg=dataclasses.replace(cfg_r, compute_dtype="float32"),
                              device="cuda", warmup=False)
    rng = np.random.default_rng(20)
    size = cfg.eval_image_size
    imgs = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    out = {}
    with torch.inference_mode():
        for b in (1, 8):
            u8 = torch.from_numpy(imgs[:b]).cuda()
            o16, o32 = svc.model(svc.prep(u8)), svc32.model(svc32.prep(u8))
            out[b] = o16
            gaps = _mask_gaps(o16, o32)
            print(f"  ResNet-50 service B={b}: bf16 vs f32 mask mean {gaps[0]:.4g}, "
                  f"binarised share differing {gaps[1]:.4g}, objectness max {gaps[2]:.4g}",
                  flush=True)
            if not _gaps_ok(gaps):
                raise AssertionError(f"the bf16 ResNet service disagrees with its f32 forward "
                                     f"at B={b}")
        masks, objs = svc.forward_u8(imgs)
        if not (torch.isfinite(masks).all() and masks.shape == (8, size // 4, size // 4)):
            raise AssertionError(f"bad ResNet service output {tuple(masks.shape)}")
        cpu = MaskFormer(svc.mcfg)
        cpu.load_state_dict(random_state_dict(cpu, cfg.seed))
        cpu = cpu.to(torch.bfloat16).eval()
        o_cpu = cpu(svc.prep(torch.from_numpy(imgs[:1]).cuda()).cpu())
        gaps_cpu = _mask_gaps({k: v.cpu() for k, v in out[1].items()}, o_cpu)
    print(f"  ResNet-50 bf16 card vs CPU (cuDNN vs the CPU's convolutions) B=1: mask mean "
          f"{gaps_cpu[0]:.4g}, binarised share differing {gaps_cpu[1]:.4g}, objectness "
          f"max {gaps_cpu[2]:.4g}", flush=True)
    if not _gaps_ok(gaps_cpu):
        raise AssertionError("the card's bf16 ResNet forward disagrees with the CPU's")
    ms = {"B=1": host_ms(lambda: svc.forward_u8(imgs[:1]), 20),
          "B=8": host_ms(lambda: svc.forward_u8(imgs), 10),
          "f32 B=8": host_ms(lambda: svc32.forward_u8(imgs), 5)}
    print("  ResNet-50 service forward_u8: " + ", ".join(f"{k} {v:.3f} ms"
                                                        for k, v in ms.items()), flush=True)
    svc.close()
    return ms


def _update_corr(a_before, a_after, b_before, b_after, skip):
    """Correlation of two runs' parameter updates (CPU state dicts), the
    keys in ``skip`` left out."""
    import torch

    ua, ub = (torch.cat([(after[k] - before[k]).flatten() for k in after if k not in skip])
              for before, after in ((a_before, a_after), (b_before, b_after)))
    return float(np.corrcoef(ua.numpy(), ub.numpy())[0, 1])


def resnet_train_check(cfg):
    """Two bf16 ResNet train steps at B=8 (buffers move, finite loss), then
    one f32 step at B=2 and 64 px on the card and on the CPU from the same
    weights."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg_r = dataclasses.replace(cfg, arch="resnet50")
    mcfg = config_from(cfg_r)
    sd = random_state_dict(MaskFormer(mcfg), cfg.seed)

    def built(c, device):
        model = MaskFormer(mcfg)
        model.load_state_dict(sd)
        model.to(device)
        opt = build_optimizer(c, model.parameters(), n_iters_per_epoch=100)
        return model, make_train_step(c, model, opt)

    model, step = built(cfg_r, "cuda")
    batch = _to_cuda(synthetic_batch(np.random.default_rng(21), cfg.batch_size,
                                     cfg.train_image_size, cfg.max_gt_masks))
    bufs = [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]
    before = {k: model.state_dict()[k].clone() for k in bufs}
    times, losses = [], []
    for _ in range(2):
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    moved = sum(not torch.equal(model.state_dict()[k], before[k]) for k in bufs)
    print(f"  ResNet-50 bf16 train steps at B={cfg.batch_size}: losses "
          f"{losses[0]:.6g}, {losses[1]:.6g}; {moved} of {len(bufs)} BN buffers moved; "
          f"{times[0]:.1f} ms, {times[1]:.1f} ms", flush=True)
    if not (np.isfinite(losses).all() and moved == len(bufs)):
        raise AssertionError("the ResNet train step gave a non-finite loss or left BN "
                             "buffers unchanged")

    small = dataclasses.replace(cfg_r, compute_dtype="float32", batch_size=2)
    sb = synthetic_batch(np.random.default_rng(22), 2, 64, cfg.max_gt_masks)
    res = {}
    for device in ("cuda", "cpu"):
        mdl, stp = built(small, device)
        b0 = {k: v.detach().clone() for k, v in mdl.state_dict().items()}
        met = stp({k: torch.from_numpy(v).to(device) for k, v in sb.items()})
        res[device] = ({k: float(v) for k, v in met.items()}, b0,
                       {k: v.detach().clone().cpu() for k, v in mdl.state_dict().items()})
    (mg, g0, g1), (mc, c0, c1) = res["cuda"], res["cpu"]
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gnorm_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / abs(mc["grad_norm"])
    corr = _update_corr({k: v.cpu() for k, v in g0.items()}, g1, c0, c1, set(bufs))
    buf_rel = max(float((g1[k] - c1[k]).abs().max() / c1[k].abs().max().clamp_min(1.0))
                  for k in bufs)
    print(f"  ResNet-50 f32 step at B=2, 64 px, card vs CPU: loss rel {loss_rel:.3g}, "
          f"grad_norm rel {gnorm_rel:.3g}, update corr {corr:.6f}, BN buffers rel "
          f"{buf_rel:.3g}", flush=True)
    if not (loss_rel <= OPT_LOSS_RTOL and gnorm_rel <= OPT_GNORM_RTOL
            and corr > OPT_MIN_UPDATE_CORR and buf_rel <= OPT_BUF_RTOL):
        raise AssertionError("the ResNet train step on the card disagrees with the CPU's")
    return times[1]


def non_bc_train_check(cfg):
    """Two bf16 steps of the non-bc head at B=8 through K2: the losses but
    the contrastive term exactly 0, 12 + 12 K2 launches a step, and
    ``linear_classifier`` and ``norm`` moved by weight decay alone (lr 1e-3,
    so that the decay is larger than an f32 ulp of the weights)."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.ops import flash_attention as fa
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg_n = dataclasses.replace(cfg, use_binary_classifier=False, lr=1e-3)
    mcfg = config_from(cfg_n)
    model = MaskFormer(mcfg)
    model.load_state_dict(random_state_dict(model, cfg.seed))
    model.cuda()
    opt = build_optimizer(cfg_n, model.parameters(), n_iters_per_epoch=100)
    step = make_train_step(cfg_n, model, opt)
    batch = _to_cuda(synthetic_batch(np.random.default_rng(23), cfg.batch_size,
                                     cfg.train_image_size, cfg.max_gt_masks))
    names = ("linear_classifier.weight", "linear_classifier.bias", "norm.weight", "norm.bias")
    params = dict(model.named_parameters())
    reset_launch_counts()
    launches, times = [], []
    for _ in range(2):
        before = {n: params[n].detach().clone() for n in names}
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        launches.append((fa.fwd_launches, fa.bwd_launches))
        m = {k: float(v) for k, v in m.items()}
        if not (m["dice_loss"] == m["ranking_loss"] == m["classification_loss"] == 0.0
                and np.isfinite(m["loss"]) and m["contrastive_loss"] != 0.0):
            raise AssertionError(f"the non-bc step's losses are not the contrastive term "
                                 f"alone: {m}")
        lr = opt.schedule(opt.count - 1)
        for n in names:
            want = before[n] + (before[n] * cfg_n.weight_decay) * (-lr)
            err = float((params[n].detach() - want).abs().max())
            if err > 1e-6 * float(before[n].abs().max()) or (
                    before[n].any() and torch.equal(params[n], before[n])):
                raise AssertionError(f"{n} did not move by weight decay alone (error {err})")
    per_step = (launches[0], (launches[1][0] - launches[0][0], launches[1][1] - launches[0][1]))
    depth = mcfg.vit.depth
    print(f"  non-bc bf16 steps at B={cfg.batch_size}: losses dice, ranking, classification "
          f"0; contrastive {m['contrastive_loss']:.6g}; K2 launches per step {per_step}; "
          f"linear_classifier and norm moved by weight decay alone; "
          f"{times[0]:.1f} ms, {times[1]:.1f} ms", flush=True)
    if any(p != (depth, depth) for p in per_step):
        raise AssertionError(f"expected {depth} + {depth} K2 launches a step, got {per_step}")
    return launches[1], times[1]


def hungarian_branch_check(cfg):
    """``criterion_forward(use_classification_loss=True)`` at B=8, L=6, Q=20,
    56 x 56 predictions and 224 px GT, under ``set_sync_debug_mode("error")``:
    its assignments against scipy's on the same costs, its losses against the
    CPU's; ms of the call and of the assignment alone."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from sod_tpu_torch.losses import criterion as crit

    rng = np.random.default_rng(24)
    b, l, q, side = cfg.batch_size, 6, cfg.n_queries, 56
    sb = synthetic_batch(rng, b, cfg.train_image_size, cfg.max_gt_masks)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    host = {"mask_pred": sig(rng.standard_normal((b, l, q, side, side)) * 2).astype(np.float32),
            "gt_masks": sb["gt_masks"].astype(np.float32), "gt_valid": sb["gt_valid"],
            "objectness": sig(rng.standard_normal((b, l, q, 1))).astype(np.float32),
            "features": rng.standard_normal((b, 384)).astype(np.float32),
            "labels": sb["labels"]}

    inputs = {device: {k: torch.from_numpy(v).to(device) for k, v in host.items()}
              for device in ("cuda", "cpu")}

    def run(device):
        t = inputs[device]
        return crit.criterion_forward(t["mask_pred"], t["gt_masks"], t["gt_valid"],
                                      t["objectness"], True, t["features"], t["labels"])

    seen = []
    solve = crit.hungarian

    def spy(cost):
        assign = solve(cost)
        seen.append((cost, assign))
        return assign

    crit.hungarian = spy
    try:
        run("cuda")                  # uploads the interpolation matrices once
        torch.cuda.synchronize()
        seen.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run("cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        crit.hungarian = solve
    cost, assign = (t.cpu().numpy() for t in seen[0])
    for c, a in zip(cost, assign):
        rows, cols = linear_sum_assignment(c)
        if not np.array_equal(a, cols[np.argsort(rows)]):
            raise AssertionError("an assignment on the card differs from scipy's")
    want = run("cpu")
    got = {k: v.cpu() for k, v in got.items()}
    if not torch.equal(got["gt_to_query"], want["gt_to_query"]):
        raise AssertionError("gt_to_query differs between the card and the CPU")
    worst = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                for k in ("loss", "dice_loss", "classification_loss", "avg_iou"))
    if worst > HUNGARIAN_RTOL:
        raise AssertionError(f"the Hungarian branch's losses differ from the CPU's "
                             f"(rel {worst:.3g})")
    ms = cuda_ms(lambda: run("cuda"), 20)
    cost_d = torch.from_numpy(cost).cuda()
    solve_ms = cuda_ms(lambda: solve(cost_d), 20)
    print(f"  Hungarian branch: {len(cost)} assignments of [2, {q}] equal scipy's, losses "
          f"within {worst:.3g} of the CPU's, no host sync; criterion {ms:.3f} ms, "
          f"assignment alone {solve_ms:.3f} ms", flush=True)
    return ms, solve_ms


def vit_helpers_check(cfg):
    """``vit_n_last_cls`` (n 4, with the patch average) of a bf16 ViT-S/8 at
    224 px, B=2, through K2 (12 launches) against the plain softmax."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import config_from
    from sod_tpu_torch.models.vit import VisionTransformer, random_vit_state_dict, vit_n_last_cls
    from sod_tpu_torch.ops import flash_attention as fa

    vcfg = config_from(cfg).vit
    if not vcfg.use_flash:
        raise AssertionError("the live config must run K2")
    sd = random_vit_state_dict(VisionTransformer(vcfg), cfg.seed)
    vits = []
    for c in (vcfg, dataclasses.replace(vcfg, use_flash=False)):
        v = VisionTransformer(c)
        v.load_state_dict(sd)
        vits.append(v.to("cuda", torch.bfloat16).eval())
    x = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        reset_launch_counts()
        got = vit_n_last_cls(vits[0], x, n=4, return_patch_avgpool=True)
        torch.cuda.synchronize()
        n_launch = fa.fwd_launches
        ref = vit_n_last_cls(vits[1], x, n=4, return_patch_avgpool=True)
        if fa.fwd_launches != n_launch:
            raise AssertionError("the plain helper launched K2")
    max_abs, rel, corr = errors(got, ref)
    print(f"  vit_n_last_cls through K2: {n_launch} launches, against the plain softmax "
          f"max_abs {max_abs:.4g}, rel L2 {rel:.3g}, corr {corr:.8f}", flush=True)
    if n_launch != vcfg.depth or not (rel <= HELPER_REL_L2 and corr > HELPER_MIN_CORR):
        raise AssertionError("vit_n_last_cls through K2 disagrees or launched K2 "
                             f"{n_launch} times")
    return n_launch


def model_options_check():
    """Phase 20: the model options off the live config at full width."""
    from sod_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    serve_ms = resnet_service_check(cfg)
    resnet_step_ms = resnet_train_check(cfg)
    (k2_fwd, k2_bwd), non_bc_ms = non_bc_train_check(cfg)
    crit_ms, solve_ms = hungarian_branch_check(cfg)
    helper_launches = vit_helpers_check(cfg)
    phase(20, f"model options: ResNet-50 service B=1 {serve_ms['B=1']:.2f} ms, B=8 "
              f"{serve_ms['B=8']:.2f} ms; ResNet-50 train step {resnet_step_ms:.1f} ms; "
              f"non-bc step {non_bc_ms:.1f} ms with {k2_fwd}+{k2_bwd} K2 launches in two "
              f"steps; Hungarian branch {crit_ms:.3f} ms without a host sync, assignments "
              f"scipy's; vit_n_last_cls {helper_launches} K2 launches")
    return {"non_bc K2": (k2_fwd, k2_bwd), "helper K2": helper_launches}


# ---------------------------------------------------------------- phase 21
# The training options of ROADMAP item 6 at the live config's full width.
EXACT_B = 16                             # two micro-batches of the live config's 8
# per tensor, max |g - g_ref| over max |g_ref|, exact mode's two
# micro-batches against one batch.  In bf16 the split moves single
# roundings (cuBLAS picks its f32 kernels by M; 12 blocks and 6 decoder
# layers carry each flip on), and a bias gradient summed over 16 x 20 query
# rows cancels to a fraction of its terms, so the gap reaches ~13 bf16 ulps
# (2^-8) of its largest element (first H100 run: 0.0525 with K2, 0.0422
# with K3 + K4); in f32 (plain attention, TF32 off) it is reassociation
EXACT_GRAD_REL, EXACT_F32_GRAD_REL = 0.15, 1e-4
REMAT_BATCHES = (8, 32)                  # the live config's and bench.py's train batch
ASYNC_IMAGES = 32                        # 4 steps an epoch at B=8
LOADER_IMAGES, LOADER_WORKERS = 64, 4


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _grad_gap(got, ref):
    """(the worst per-tensor max |got - ref| over max |ref|, its tensor)."""
    return max((float((got[n] - ref[n]).abs().max())
                / max(float(ref[n].abs().max()), 1e-30), n) for n in ref)


def _timed_steps(step, batch, n: int = 3) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _step_builder(cfg, mcfg, sd):
    """``(accum, mode) -> (model, train_step)`` from the weights ``sd``."""
    from sod_tpu_torch.models.maskformer import MaskFormer
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    def build(accum: int = 1, mode: str = "averaged"):
        model = MaskFormer(mcfg)
        model.load_state_dict(sd)
        model.cuda()
        opt = build_optimizer(cfg, model.parameters(), n_iters_per_epoch=100)
        return model, make_train_step(cfg, model, opt, accum_steps=accum, mode=mode)

    return build


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (F.interpolate's backward without
    atomics; cuBLAS on the fixed workspace ``card_check`` sets)."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _release() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def exact_mode_check(cfg, fused_train: bool = False) -> dict:
    """Exact accumulation at B=16 as two micro-batches of 8 with the labels
    repeated across them (image i and i + 8 share a label, so every positive
    pair spans the two): K2's launches (K3's and K4's under
    ``use_fused_train``) in one step; pass 1's features against pass 2's;
    the summed gradients against one B=16 step; the step through the plain
    versions against it (phase 7's bounds); exact, averaged and one-batch
    step ms."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict

    cfg_x = dataclasses.replace(cfg, batch_size=EXACT_B, use_fused_train=fused_train)
    mcfg = config_from(cfg_x)
    depth = mcfg.vit.depth
    sd = random_state_dict(MaskFormer(mcfg), cfg.seed)
    build = _step_builder(cfg_x, mcfg, sd)
    host = synthetic_batch(np.random.default_rng(25), EXACT_B, cfg.train_image_size,
                           cfg.max_gt_masks)
    host["labels"] = np.tile(np.arange(EXACT_B // 2, dtype=np.int32), 2)
    batch = _to_cuda(host)
    name = "use_fused_train (K3 + K4)" if fused_train else "default (K2)"

    exact_model, exact = build(2, "exact")
    seen = []
    hook = exact_model.register_forward_hook(
        lambda mod, args, out: seen.append((torch.is_grad_enabled(),
                                            out["features"].detach().clone())))
    reset_launch_counts()
    mx = exact(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    hook.remove()
    if [g for g, _ in seen] != [False, False, True, True]:
        raise AssertionError(f"exact step forwards (grad enabled): {[g for g, _ in seen]}")
    z_gap = max(float((z1 - z2).abs().max()) for (_, z1), (_, z2) in zip(seen[:2], seen[2:]))
    g_exact = _grads(exact_model)
    one_model, one = build(1)
    m1 = one(batch)
    torch.cuda.synchronize()
    gap, worst = _grad_gap(g_exact, _grads(one_model))

    plain_model, plain = build(2, "exact")
    with (plain_fused_train() if fused_train else _PlainFlash()):
        mp = plain(batch)
    torch.cuda.synchronize()
    mx, m1, mp = ({k: float(v) for k, v in m.items()} for m in (mx, m1, mp))
    if not (all(np.isfinite(list(mx.values()))) and mx["contrastive_loss"] > 0):
        raise AssertionError(f"exact step metrics: {mx}")
    upd_x = torch.cat([(v.cpu() - sd[k]).flatten() for k, v in exact_model.state_dict().items()])
    upd_p = torch.cat([(v.cpu() - sd[k]).flatten() for k, v in plain_model.state_dict().items()])
    corr = float(np.corrcoef(upd_x.numpy(), upd_p.numpy())[0, 1])
    loss_rel = abs(mx["loss"] - mp["loss"]) / abs(mp["loss"])
    gnorm_rel = abs(mx["grad_norm"] - mp["grad_norm"]) / abs(mp["grad_norm"])

    f32_gap = None
    if not fused_train:
        # the same comparison in f32 with plain attention (the kernels take bf16)
        cfg_f = dataclasses.replace(cfg_x, compute_dtype="float32", use_pallas_attention=False)
        build_f = _step_builder(cfg_f, config_from(cfg_f), sd)
        (fx_model, fx), (f1_model, f1) = build_f(2, "exact"), build_f(1)
        fx(batch)
        f1(batch)
        torch.cuda.synchronize()
        f32_gap, f32_worst = _grad_gap(_grads(fx_model), _grads(f1_model))
        del fx_model, f1_model, fx, f1

    avg_model, avg = build(2, "averaged")
    ma = {k: float(v) for k, v in avg(batch).items()}
    times = {}
    for label, step in (("exact", exact), ("averaged", avg), ("one batch", one)):
        times[label] = _timed_steps(step, batch)
    print(f"  exact step, {name}, B={EXACT_B} as 2 x {EXACT_B // 2}: loss {mx['loss']:.6g}, "
          f"contrastive {mx['contrastive_loss']:.6g} (one batch {m1['contrastive_loss']:.6g}, "
          f"averaged {ma['contrastive_loss']:.6g}: no positive pair inside a micro-batch); "
          f"launches {counts}; pass 1 vs pass 2 features max_abs {z_gap:.3g}; gradients vs one "
          f"B={EXACT_B} step: worst per-tensor max err / max {gap:.3g} ({worst})"
          + ("" if f32_gap is None else
             f", in f32 with plain attention {f32_gap:.3g} ({f32_worst})")
          + f"; vs plain "
          f"exact step loss rel {loss_rel:.3g}, grad_norm rel {gnorm_rel:.3g}, update corr "
          f"{corr:.6f}; step ms exact {times['exact']:.1f}, averaged {times['averaged']:.1f}, "
          f"one batch {times['one batch']:.1f} [{CARD}]", flush=True)
    if fused_train:
        want = {"K3 fwd": 4 * depth, "K3 bwd": 2 * depth, "K4 fwd": 4 * depth,
                "K4 bwd": 2 * depth, "K2 fwd": 0, "K2 bwd": 0}
    else:
        want = {"K2 fwd": 4 * depth, "K2 bwd": 2 * depth, "K3 fwd": 0, "K4 fwd": 0}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"exact step launches {counts}, expected {want}")
    if z_gap != 0.0:
        raise AssertionError(f"pass 1's features differ from pass 2's by {z_gap}")
    if f32_gap is not None and not f32_gap <= EXACT_F32_GRAD_REL:
        raise AssertionError(f"f32 exact gradients off the one-batch step's: {f32_gap}")
    if not gap <= EXACT_GRAD_REL:
        raise AssertionError(f"exact gradients off the one-batch step's: {gap} at {worst}")
    if not (loss_rel <= STEP_LOSS_RTOL and gnorm_rel <= STEP_GNORM_RTOL
            and corr > STEP_MIN_UPDATE_CORR):
        raise AssertionError("the exact step disagrees with its plain versions")
    del exact_model, one_model, plain_model, avg_model, exact, one, plain, avg
    _release()
    return {"launches": counts, "z_gap": z_gap, "grad_gap": gap, "f32_gap": f32_gap,
            "ms": times}


def remat_check(cfg) -> dict:
    """Remat on the default path at B=8 and B=32, one step from the same
    weights with and without it under torch's deterministic algorithms (the
    pixel decoder's F.interpolate backward otherwise sums with atomics):
    gradients bit for bit, K2's launches, the step's peak device memory above
    what was resident before it; then step ms both ways with the default
    algorithms."""
    import dataclasses

    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict

    out = {}
    sd = None
    for b in REMAT_BATCHES:
        batch = _to_cuda(synthetic_batch(np.random.default_rng(26 + b), b,
                                         cfg.train_image_size, cfg.max_gt_masks))
        grads, row = {}, {}
        for label, remat in (("off", False), ("on", True)):
            cfg_r = dataclasses.replace(cfg, batch_size=b, remat=remat)
            mcfg = config_from(cfg_r)
            sd = sd or random_state_dict(MaskFormer(mcfg), cfg.seed)
            model, step = _step_builder(cfg_r, mcfg, sd)()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with _deterministic():
                step(batch)
                torch.cuda.synchronize()
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() - resident
            grads[label] = _grads(model)
            row[label] = {"K2": (counts["K2 fwd"], counts["K2 bwd"]),
                          "peak GiB": peak / 2 ** 30, "ms": _timed_steps(step, batch)}
            del model, step
            _release()
        row["max_abs"] = max(float((grads["on"][n] - grads["off"][n]).abs().max())
                             for n in grads["off"])
        out[b] = row
        del grads
        _release()
        print(f"  remat at B={b}: K2 launches a step off {row['off']['K2']}, on "
              f"{row['on']['K2']}; step peak above resident {row['off']['peak GiB']:.3f} -> "
              f"{row['on']['peak GiB']:.3f} GiB; step ms {row['off']['ms']:.1f} -> "
              f"{row['on']['ms']:.1f}; gradients on vs off (deterministic algorithms) "
              f"max_abs {row['max_abs']:.3g} [{CARD}]", flush=True)
    depth = config_from(cfg).vit.depth
    for b, row in out.items():
        if row["on"]["K2"] != (2 * depth, depth) or row["off"]["K2"] != (depth, depth):
            raise AssertionError(f"remat K2 launches at B={b}: {row}")
        if row["max_abs"] != 0.0:
            raise AssertionError(f"remat gradients at B={b} off by {row['max_abs']}")
        if not row["on"]["peak GiB"] < row["off"]["peak GiB"]:
            raise AssertionError(f"remat did not lower the step's peak at B={b}: {row}")
    return out


def async_checkpoint_check() -> dict:
    """``cli.train --async-checkpoint`` for 2 epochs on a synthetic DUTS-TR,
    under torch's deterministic algorithms: the file against the weights at
    the moment ``save`` was called and against a synchronous run from the
    same seed, beside a second synchronous run, all bit for bit; the
    training thread's time in each checkpoint call; epoch s both ways; then
    ``--resume --async-checkpoint`` for a third epoch."""
    import torch
    import yaml

    from sod_tpu_torch.cli import train as cli
    from sod_tpu_torch.train import checkpoints
    from sod_tpu_torch.train import trainer as trainer_mod

    taken, saved = [], []
    real_async, real_sync = checkpoints.AsyncSaver.save, trainer_mod.save_checkpoint

    def async_save(self, path, model, optimizer=None, **kw):
        saved.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_async(self, path, model, optimizer, **kw)
        taken.append(("async", time.perf_counter() - t0))

    def sync_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_sync(*args, **kw)
        taken.append(("sync", time.perf_counter() - t0))

    def max_abs(a, b):
        return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max()) for k in a)

    runs = {}
    checkpoints.AsyncSaver.save, trainer_mod.save_checkpoint = async_save, sync_save
    try:
        with tempfile.TemporaryDirectory() as root, _deterministic():
            with open(CONFIG) as f:
                settings = yaml.safe_load(f)
            pm = write_duts(root, ASYNC_IMAGES, settings["train_image_size"])
            for name, argv in (("sync", []), ("async", ["--async-checkpoint"]),
                               ("sync_again", [])):
                settings.update(dir_ckpt=os.path.join(root, name), dir_dataset=root,
                                pseudo_masks_fp=pm, n_epochs=2)
                fp = os.path.join(root, f"{name}.yaml")
                with open(fp, "w") as f:
                    yaml.safe_dump(settings, f)
                reset_launch_counts()
                t0 = time.perf_counter()
                cli.main(["--config", fp, "--device", "cuda", *argv])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                ckpt = os.path.join(root, name, os.listdir(os.path.join(root, name))[0])
                state = checkpoints.restore_checkpoint(os.path.join(ckpt, "latest_model.pt"))
                runs[name] = {"seconds": seconds, "state": state, "yaml": fp, "dir": ckpt,
                              "K2": (launch_counts()["K2 fwd"], launch_counts()["K2 bwd"])}
            # the async run's file holds the weights at its last save call
            snap_gap = max_abs(runs["async"]["state"]["model"], saved[-1])
            floor = max_abs(runs["sync_again"]["state"]["model"], runs["sync"]["state"]["model"])
            gap = max_abs(runs["async"]["state"]["model"], runs["sync"]["state"]["model"])
            equal = sum(torch.equal(runs["async"]["state"]["model"][k], v)
                        for k, v in runs["sync"]["state"]["model"].items())
            with open(runs["async"]["yaml"]) as f:
                settings = yaml.safe_load(f)
            settings["n_epochs"] = 3
            with open(runs["async"]["yaml"], "w") as f:
                yaml.safe_dump(settings, f)
            cli.main(["--config", runs["async"]["yaml"], "--device", "cuda", "--resume",
                      "--async-checkpoint"])
            torch.cuda.synchronize()
            with open(os.path.join(runs["async"]["dir"], "metrics.jsonl")) as f:
                last = [json.loads(line) for line in f if "avg_loss" in line][-1]
    finally:
        checkpoints.AsyncSaver.save, trainer_mod.save_checkpoint = real_async, real_sync
    steps = ASYNC_IMAGES // settings["batch_size"]
    n_tensors = len(runs["sync"]["state"]["model"])
    sync_ms = [t * 1e3 for k, t in taken if k == "sync"]
    async_ms = [t * 1e3 for k, t in taken if k == "async"]
    epoch_s = {k: runs[k]["seconds"] / 2 for k in ("sync", "async")}
    print(f"  --async-checkpoint, 2 epochs of {steps} steps: the file against the weights "
          f"at save max_abs {snap_gap:.3g}; against the synchronous run max_abs {gap:.3g} "
          f"({equal} of {n_tensors} tensors equal), two synchronous runs {floor:.3g}; "
          f"checkpoint call on the training thread sync "
          f"{', '.join(f'{t:.1f}' for t in sync_ms)} ms, async "
          f"{', '.join(f'{t:.1f}' for t in async_ms)} ms; epoch s sync {epoch_s['sync']:.2f}, "
          f"async {epoch_s['async']:.2f}; --resume: epoch {last['epoch']:.0f} step "
          f"{last['step']}; K2 launches a run {runs['async']['K2']} [{CARD}]", flush=True)
    if snap_gap != 0.0:
        raise AssertionError(f"the async checkpoint is not the state at save: {snap_gap}")
    if gap != 0.0 or floor != 0.0:
        raise AssertionError(f"async checkpoint off the synchronous run by {gap} (two "
                             f"synchronous runs: {floor})")
    if last["epoch"] != 3 or last["step"] != 3 * steps:
        raise AssertionError(f"resume did not continue the run: {last}")
    return {"snapshot_gap": snap_gap, "gap": gap, "floor": floor, "epoch_s": epoch_s,
            "save_ms": {"sync": sync_ms, "async": async_ms}}


class _RecordingVisualizer:
    """Stands in for ``Visualizer`` where matplotlib does not import: checks
    and counts the hooks' inputs."""

    def __init__(self):
        self.calls = 0

    def _check(self, masks, objectness):
        masks = np.asarray(masks)
        if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
            raise AssertionError("visualizer masks outside [0, 1]")
        if objectness is not None and not np.isfinite(np.asarray(objectness)).all():
            raise AssertionError("visualizer objectness not finite")
        self.calls += 1

    def __call__(self, epoch, it, batch, outputs=None):
        self._check(outputs["mask_pred"], outputs["objectness"])

    def eval_grid(self, image_u8, gt_mask, pred_masks, objectness, fp):
        self._check(pred_masks, objectness)


def visualizer_check(cfg) -> dict:
    """The Trainer's hook (masks from ``make_eval_step``: K1, 12 launches a
    call) over one epoch of 16 synthetic images, and the Evaluator's
    (masks from the default path: K2's masked forward) on a 32-image
    DUTS-TE at B=16 rendering every batch: PNGs written where matplotlib
    imports, else a recording visualizer."""
    import dataclasses

    import torch

    from sod_tpu_torch.train.evaluator import Evaluator
    from sod_tpu_torch.train.trainer import Trainer
    from sod_tpu_torch.utils.visualizer import Visualizer

    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    depth = 12
    with tempfile.TemporaryDirectory() as root:
        pm = write_duts(root, 16, cfg.train_image_size)
        write_duts_te(root, 32, 200, 400, seed=28)
        tcfg = dataclasses.replace(cfg, dir_ckpt=os.path.join(root, "ckpt"),
                                   dir_dataset=root, pseudo_masks_fp=pm)
        vis = Visualizer(os.path.join(root, "vis")) if have_mpl else _RecordingVisualizer()
        trainer = Trainer(tcfg, device="cuda", visualizer=vis)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer._train_epoch(1)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        train_counts = launch_counts()
        train_calls = None if have_mpl else vis.calls
        evaluator = Evaluator(trainer.model, tcfg, visualizer=vis, vis_every=1,
                              batch_size=EVAL_B, device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        evaluator("duts")
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        eval_counts = launch_counts()
        if have_mpl:
            pngs = {d: sorted(os.listdir(os.path.join(root, "vis", d)))
                    for d in ("01", "duts")}
            n_train, n_eval = len(pngs["01"]), len(pngs["duts"])
        else:
            n_train, n_eval = train_calls, vis.calls - train_calls
        del trainer, evaluator
    _release()
    how = ("matplotlib imports: PNGs written" if have_mpl else
           "matplotlib does not import: PNG rendering not exercised, a recording "
           "visualizer checked the hooks' inputs")
    what = "PNGs written" if have_mpl else "calls recorded"
    print(f"  visualizer hooks ({how}): the Trainer's epoch of 2 steps, {n_train} "
          f"{what}, K1 launches {train_counts['K1']} "
          f"(K2 {train_counts['K2 fwd']} + {train_counts['K2 bwd']}), "
          f"{t_train:.2f} s; the Evaluator's 2 batches, {n_eval} {what}, K2 "
          f"forward launches {eval_counts['K2 fwd']}, K6 {eval_counts['K6']}, "
          f"{t_eval:.2f} s [{CARD}]", flush=True)
    if train_counts["K1"] != 2 * depth or eval_counts["K2 fwd"] != 2 * depth:
        raise AssertionError(f"visualizer launches: {train_counts}, {eval_counts}")
    if (n_train, n_eval) != (2, 2):
        raise AssertionError(f"visualizer {what}: {n_train}, {n_eval}")
    return {"matplotlib": have_mpl, "K1": train_counts["K1"]}


def process_loader_check(cfg) -> dict:
    """``DataLoader(use_processes=True)`` with 4 forked workers, forked
    after CUDA is up in this process, against the thread loader on a
    64-image synthetic DUTS-TR: every batch byte-equal; img/s both ways."""
    import dataclasses

    import torch

    from sod_tpu_torch.data.loader import DataLoader, collate_train
    from sod_tpu_torch.train.trainer import train_dataset

    torch.zeros(1, device="cuda")                      # CUDA is up before the fork
    if not torch.cuda.is_initialized():
        raise AssertionError("CUDA is not initialised before the fork")
    with tempfile.TemporaryDirectory() as root:
        pm = write_duts(root, LOADER_IMAGES, cfg.train_image_size)
        ds = train_dataset(dataclasses.replace(cfg, dir_dataset=root, pseudo_masks_fp=pm))
        ds.set_mode("train")
        ds.use_data_augmentation_(True)
        ds.train_u8, ds.seed = True, cfg.seed
        batches, rates = {}, {}
        for procs in (False, True):
            loader = DataLoader(ds, batch_size=cfg.batch_size, shuffle=True,
                                num_workers=LOADER_WORKERS, seed=cfg.seed,
                                collate_fn=lambda s: collate_train(s, cfg.max_gt_masks,
                                                                   cfg.batch_size),
                                use_processes=procs)
            loader.set_epoch(1)
            t0 = time.perf_counter()
            it = iter(loader)
            batches[procs] = [next(it)]
            t1 = time.perf_counter()
            batches[procs] += list(it)
            t2 = time.perf_counter()
            rates[procs] = (LOADER_IMAGES / (t2 - t0),
                            (LOADER_IMAGES - cfg.batch_size) / (t2 - t1), (t1 - t0) * 1e3)
    differ = [k for a, b in zip(batches[False], batches[True]) for k in a
              if (a[k] != b[k] if k == "filename" else not np.array_equal(a[k], b[k]))]
    print(f"  process loader, {LOADER_WORKERS} workers forked after CUDA init: "
          f"{len(batches[True])} batches, {'byte-equal to' if not differ else 'DIFFERENT from'} "
          f"the thread loader's; img/s threads {rates[False][0]:.1f} (after the first "
          f"batch {rates[False][1]:.1f}; first batch {rates[False][2]:.1f} ms), processes "
          f"{rates[True][0]:.1f} ({rates[True][1]:.1f}; {rates[True][2]:.1f} ms) "
          f"[{CARD}]", flush=True)
    if differ or len(batches[True]) != len(batches[False]) or not batches[True]:
        raise AssertionError(f"process loader batches differ: {differ}")
    return {"img/s": rates}


def training_options_check():
    """Phase 21: the training options of ROADMAP item 6 at full width."""
    from sod_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    t0 = time.perf_counter()
    exact = exact_mode_check(cfg)
    exact_fused = exact_mode_check(cfg, fused_train=True)
    remat = remat_check(cfg)
    saver = async_checkpoint_check()
    vis = visualizer_check(cfg)
    loader = process_loader_check(cfg)
    k2, fused = exact["launches"], exact_fused["launches"]
    r8, r32 = remat[8], remat[32]
    phase(21, f"training options: exact step K2 {k2['K2 fwd']}+{k2['K2 bwd']}, fused K3 "
              f"{fused['K3 fwd']}+{fused['K3 bwd']} K4 {fused['K4 fwd']}+{fused['K4 bwd']}, "
              f"gradients vs one batch {exact['grad_gap']:.3g} / {exact_fused['grad_gap']:.3g}, "
              f"{exact['ms']['exact']:.1f} ms vs averaged {exact['ms']['averaged']:.1f}; remat "
              f"K2 {r8['on']['K2'][0]}+{r8['on']['K2'][1]}, peak {r8['off']['peak GiB']:.2f} -> "
              f"{r8['on']['peak GiB']:.2f} GiB at B=8, {r32['off']['peak GiB']:.2f} -> "
              f"{r32['on']['peak GiB']:.2f} GiB at B=32; async checkpoint equal to the state at "
              f"save; visualizer {'PNGs' if vis['matplotlib'] else 'recorded'} with "
              f"{vis['K1']} K1 launches; process loader byte-equal, "
              f"{loader['img/s'][True][0]:.1f} vs {loader['img/s'][False][0]:.1f} img/s; "
              f"{time.perf_counter() - t0:.1f} s [{CARD}]")

# phase 22: the data mesh at a world size of 1 over NCCL.  The mesh step
# against the step with no mesh from the same weights and batch, both under
# torch's deterministic algorithms: equal bit for bit is expected (the
# all-reduce of one rank returns its input), and the largest difference is
# printed and held to MESH_MAX_ABS
MESH_MAX_ABS = 0.0
MESH_EVAL_IMAGES, MESH_EVAL_B, MESH_MASKGEN_IMAGES, MESH_MASKGEN_B = 12, 8, 6, 4
MESH_TIMED_STEPS, MESH_ROUNDS, MESH_PROFILED_STEPS = 5, 3, 3


def _mesh_pair(cfg, sd, batch, mesh, level: str, n_steps: int = 2):
    """``n_steps`` steps from ``sd`` with no mesh and on ``mesh`` under
    ``level`` (sharded by the specs of 2 ranks): per run its metrics, its
    weights and moments after the steps, and the launches of the mesh run."""
    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from
    from sod_tpu_torch.parallel import fsdp_specs, shard_batch
    from sod_tpu_torch.parallel.fsdp import StateLayout
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    mcfg = config_from(cfg)
    out = {}
    for name in ("no mesh", "mesh"):
        model = MaskFormer(mcfg)
        model.load_state_dict(sd)
        model.cuda()
        layout = None
        if name == "mesh":
            layout = StateLayout(model, mesh, level, specs=fsdp_specs(model, mesh, n=2))
        opt = build_optimizer(cfg, model.parameters() if layout is None else layout.tensors,
                              n_iters_per_epoch=100)
        step = make_train_step(cfg, model, opt, layout=layout)
        local = shard_batch(batch, mesh) if layout is not None else batch
        reset_launch_counts()
        with _deterministic():
            for _ in range(n_steps):
                metrics = step(local)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        if layout is None:
            state, opt_state = model.state_dict(), opt.state_dict()
        else:
            state, opt_state = layout.full_state(opt)
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": counts,
                     "state": {k: v.detach().clone() for k, v in state.items()},
                     "moments": opt_state["mu"] + opt_state["nu"], "step": step,
                     "batch": local, "sharded": 0 if layout is None else len(layout.sharded)}
        del model, opt
    a, b = out["no mesh"], out["mesh"]
    gap = max([float((a["state"][k].float() - b["state"][k].float()).abs().max())
               for k in a["state"]]
              + [float((x - y).abs().max()) for x, y in zip(a["moments"], b["moments"])]
              + [abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]])
    return out, gap


def data_mesh_check():
    """Phase 22: the data mesh (ROADMAP item 12a) on the card, one rank over
    NCCL, every collective called, each part against the path with no mesh
    in this call."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.data.mask_generator import MaskGenerator
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.parallel import make_mesh
    from sod_tpu_torch.parallel.mesh import device_limit
    from sod_tpu_torch.train.evaluator import Evaluator

    t0 = time.perf_counter()
    try:
        make_mesh(device_limit("cuda") + 1, "cuda")
        raise AssertionError("make_mesh beyond the cards did not raise")
    except ValueError as e:
        print(f"  make_mesh({device_limit('cuda') + 1}): ValueError {e}", flush=True)
    mesh = make_mesh(1, "cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the mesh runs {dist.get_backend()}, not NCCL")
    print(f"  mesh {mesh}, backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}", flush=True)
    report = {}
    try:
        base = load_config(CONFIG)
        depth = config_from(base).vit.depth
        sd = random_state_dict(MaskFormer(config_from(base)), base.seed)
        batch = _to_cuda(synthetic_batch(np.random.default_rng(22), base.batch_size,
                                         base.train_image_size, base.max_gt_masks))
        parts = {
            "a default step": (base, "none", {"K2 fwd": 2 * depth, "K2 bwd": 2 * depth}),
            "b use_fused_train, zero1": (
                base.replace(use_fused_train=True, fsdp="zero1"), "zero1",
                {"K3 fwd": 2 * depth, "K3 bwd": 2 * depth, "K4 fwd": 2 * depth,
                 "K4 bwd": 2 * depth}),
            "c fsdp full, plain path": (base.replace(use_pallas_attention=False, fsdp="full"),
                                        "full", {})}
        default_runs = None
        for part, (cfg, level, want) in parts.items():
            runs, gap = _mesh_pair(cfg, sd, batch, mesh, level)
            got = runs["mesh"]["counts"]
            m = runs["mesh"]["metrics"]
            print(f"  ({part}) 2 steps at B={cfg.batch_size}: launches {got} (expected {want}), "
                  f"{runs['mesh']['sharded']} leaves through the reduce-scatter; mesh vs no "
                  f"mesh max_abs {gap:.3g} over weights, moments and metrics; loss "
                  f"{m['loss']:.6g}, grad_norm {m['grad_norm']:.6g} [{CARD}]", flush=True)
            if got != want or runs["no mesh"]["counts"] != want:
                raise AssertionError(f"({part}) launches {got} / no mesh "
                                     f"{runs['no mesh']['counts']}, expected {want}")
            if gap > MESH_MAX_ABS or not all(np.isfinite(list(m.values()))):
                raise AssertionError(f"({part}) the mesh step differs from the step "
                                     f"with no mesh by {gap}")
            report[part] = {"launches": got, "max_abs": gap}
            if level == "none":
                default_runs = runs
            _release()

        # (d) the Evaluator: the default path's K2 masked forward and K6
        with tempfile.TemporaryDirectory() as root:
            write_duts_te(root, MESH_EVAL_IMAGES, EVAL_SIDE // 2, EVAL_SIDE, 22)
            cfg = base.replace(dir_dataset=root)
            model = MaskFormer(config_from(cfg))
            model.load_state_dict(sd)
            model.cuda()
            res = {}
            n_batches = -(-MESH_EVAL_IMAGES // MESH_EVAL_B)
            for name, m in (("no mesh", None), ("mesh", mesh)):
                ev = Evaluator(model, cfg, config_from(cfg), batch_size=MESH_EVAL_B,
                               device="cuda", mesh=m)
                reset_launch_counts()
                res[name] = ev("duts")
                torch.cuda.synchronize()
                res[name + " counts"] = {k: v for k, v in launch_counts().items() if v}
            want = {"K2 fwd": depth * n_batches, "K6": n_batches}
            gap = max(abs(res["mesh"][k] - res["no mesh"][k]) for k in res["no mesh"])
            print(f"  (d) Evaluator, {MESH_EVAL_IMAGES} images at B={MESH_EVAL_B}: launches "
                  f"{res['mesh counts']} (expected {want}); 14 metric means, mesh vs no mesh "
                  f"max_abs {gap:.3g}; iou {res['mesh']['iou']:.6g} [{CARD}]", flush=True)
            if res["mesh counts"] != want or res["no mesh counts"] != want or gap > 0:
                raise AssertionError("(d) the Evaluator on the mesh differs")
            report["d evaluator"] = {"launches": res["mesh counts"], "max_abs": gap}
            del model
            _release()

        # (e) MaskGenerator: rank 0's JSON, the labels gathered
        with tempfile.TemporaryDirectory() as root:
            paths = write_maskgen_images(root, MESH_MASKGEN_IMAGES, seed=22)
            js = {}
            for name, m in (("no mesh", None), ("mesh", mesh)):
                js[name] = json.dumps(MaskGenerator(device="cuda", batch_size=MESH_MASKGEN_B,
                                                    mesh=m)(paths))
            same = js["mesh"] == js["no mesh"]
            print(f"  (e) MaskGenerator on {MESH_MASKGEN_IMAGES} images at B={MESH_MASKGEN_B} "
                  f"(the last batch wrap-padded): RLE JSON of {len(js['mesh'])} bytes, "
                  f"{'byte-equal to' if same else 'DIFFERENT from'} the run with no mesh",
                  flush=True)
            if not same:
                raise AssertionError("(e) MaskGenerator's JSON differs on the mesh")
            report["e maskgen"] = {"bytes": len(js["mesh"])}
            _release()

        # (g) the rank's rows through workers forked after NCCL is up: a
        # worker that touched CUDA would raise in the fork
        from sod_tpu_torch.data.loader import DataLoader, collate_train
        from sod_tpu_torch.parallel import batch_sharding
        from sod_tpu_torch.train.trainer import train_dataset

        with tempfile.TemporaryDirectory() as root:
            pm = write_duts(root, 2 * base.batch_size, base.train_image_size)
            ds = train_dataset(dataclasses.replace(base, dir_dataset=root, pseudo_masks_fp=pm))
            ds.set_mode("train")
            ds.use_data_augmentation_(True)
            ds.train_u8, ds.seed = True, base.seed
            got = {}
            for procs in (False, True):
                loader = DataLoader(ds, batch_size=base.batch_size, shuffle=True,
                                    num_workers=LOADER_WORKERS, seed=base.seed,
                                    rows=batch_sharding(mesh, base.batch_size),
                                    collate_fn=lambda b: collate_train(b, base.max_gt_masks),
                                    use_processes=procs)
                loader.set_epoch(1)
                got[procs] = list(loader)
        same = len(got[True]) == len(got[False]) == 2 and all(
            np.array_equal(a[k], b[k]) if k != "filename" else a[k] == b[k]
            for a, b in zip(got[False], got[True]) for k in a)
        print(f"  (g) the rank's rows of {len(got[True])} batches through {LOADER_WORKERS} "
              f"workers forked after NCCL init: {'byte-equal to' if same else 'DIFFERENT from'} "
              f"the thread loader's", flush=True)
        if not same:
            raise AssertionError("(g) the process loader's rows differ")

        # (f) step ms with and without the mesh, in turns
        times = {"no mesh": [], "mesh": []}
        for _ in range(MESH_ROUNDS):
            for name in ("no mesh", "mesh"):
                run = default_runs[name]
                times[name].append(_timed_steps(run["step"], run["batch"], MESH_TIMED_STEPS))
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"  (f) default step at B={base.batch_size}, {MESH_ROUNDS} rounds of "
              f"{MESH_TIMED_STEPS} in turns: no mesh {med['no mesh']:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in times['no mesh'])}), mesh "
              f"{med['mesh']:.3f} ms ({', '.join(f'{t:.3f}' for t in times['mesh'])}) "
              f"[{CARD}]", flush=True)
        # the same steps profiled: device busy ms and kernels a step, and
        # the host operators whose self time grows most on the mesh
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        cpu = {}
        for name in ("no mesh", "mesh"):
            run = default_runs[name]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(MESH_PROFILED_STEPS):
                    run["step"](run["batch"])
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            med[name + " busy"] = (sum(e.self_device_time_total for e in kernels) / 1e3
                                   / MESH_PROFILED_STEPS)
            med[name + " kernels"] = sum(e.count for e in kernels) / MESH_PROFILED_STEPS
            cpu[name] = {e.key: e.self_cpu_time_total / 1e3 / MESH_PROFILED_STEPS
                         for e in events if e.device_type == DeviceType.CPU}
        grown = sorted(((cpu["mesh"].get(k, 0.0) - cpu["no mesh"].get(k, 0.0), k)
                        for k in set(cpu["mesh"]) | set(cpu["no mesh"])), reverse=True)[:3]
        print(f"  (f) profiled, {MESH_PROFILED_STEPS} steps each: device busy "
              f"{med['no mesh busy']:.3f} ms a step with no mesh, {med['mesh busy']:.3f} on "
              f"the mesh; kernels a step {med['no mesh kernels']:.0f} and "
              f"{med['mesh kernels']:.0f}; host self ms a step grown most on the mesh: "
              + ", ".join(f"{k[:40]} {d:+.3f}" for d, k in grown) + f" [{CARD}]", flush=True)
        report["f step ms"] = med
    finally:
        dist.destroy_process_group()
    a, b = report["a default step"]["launches"], report["b use_fused_train, zero1"]["launches"]
    phase(22, f"data mesh on the card (1 rank, NCCL): default step K2 {a['K2 fwd'] // 2}+"
              f"{a['K2 bwd'] // 2} a step, fused zero1 K3 {b['K3 fwd'] // 2}+{b['K3 bwd'] // 2} "
              f"K4 {b['K4 fwd'] // 2}+{b['K4 bwd'] // 2}, fsdp full on the plain path, each "
              f"equal to the step with no mesh (max_abs "
              f"{max(r['max_abs'] for k, r in report.items() if 'max_abs' in r):.3g}); "
              f"Evaluator metrics equal ({report['d evaluator']['launches']}); MaskGenerator "
              f"JSON byte-equal; step {report['f step ms']['mesh']:.1f} ms vs "
              f"{report['f step ms']['no mesh']:.1f} with no mesh; "
              f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    return report


# phase 23: the model-sharding layouts at one rank over NCCL.  Each layout
# runs its own code (the split and merge of the packed qkv, Megatron's f and
# g, the GPipe ticks with M = 2, the ring with its pad mask) in one f32 train
# step at full width against the step with no mesh from the same weights and
# batch.  Adam's first update moves a weight by the learning rate whatever
# its gradient's size (6e-6 in the shipped config), so two runs whose
# near-zero gradients round apart differ by at most twice that; the moments
# (0.1 g and 0.001 g^2 of the clipped gradient) and the metrics are held
# relative to the largest of the run with no mesh.  The two-rank arithmetic
# (two head groups' row-parallel partials, two query slices absorbing both
# key/value slices) is held to f32 reassociation, and the SP Evaluator's 14
# metric means to LAYOUT_EVAL_MAX_ABS
LAYOUT_MAX_ABS, LAYOUT_MAX_REL = 2e-5, 1e-4
LAYOUT_SPLIT_MAX_ABS = 1e-4
LAYOUT_EVAL_MAX_ABS, LAYOUT_EVAL_IMAGES, LAYOUT_EVAL_B = 1e-3, 8, 8
LAYOUT_ROUNDS, LAYOUT_TIMED_STEPS = 3, 3


def _layout_step(cfg, sd, batch, mesh, kind: str):
    """One step from ``sd`` under ``kind``'s layout on ``mesh`` (no mesh for
    None): its metrics, whole weights and moments after it, the kernels it
    launched, and the step and batch for timing."""
    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from
    from sod_tpu_torch.parallel import shard_batch
    from sod_tpu_torch.parallel.layouts import train_layout
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    model = MaskFormer(config_from(cfg))
    model.load_state_dict(sd)
    model.cuda()
    apply_fn, layout = train_layout(cfg, model.cfg, model, mesh)
    opt = build_optimizer(cfg, model.parameters() if layout is None else layout.tensors,
                          n_iters_per_epoch=100)
    step = make_train_step(cfg, model, opt, layout=layout, apply_fn=apply_fn)
    local = batch if mesh is None else shard_batch(batch, mesh)
    reset_launch_counts()
    metrics = step(local)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    if layout is None:
        state, opt_state = model.state_dict(), opt.state_dict()
    else:
        state, opt_state = layout.full_state(opt)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": counts,
            "state": {k: v.detach().clone() for k, v in state.items()},
            "moments": opt_state["mu"] + opt_state["nu"], "step": step, "batch": local,
            "kind": kind}


def _layout_gaps(ref, got):
    """(max abs over the weights, max relative over the moments, max
    relative over the metrics) of ``got`` against ``ref``."""
    w = max(float((ref["state"][k].float() - got["state"][k].float()).abs().max())
            for k in ref["state"])
    m = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
            for a, b in zip(ref["moments"], got["moments"]) if a.numel())
    r = max(abs(ref["metrics"][k] - got["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-30)
            for k in ref["metrics"])
    return w, m, r


def _two_rank_arithmetic(sd, cfg):
    """The ranks' arithmetic one process can hold, on CUDA tensors: TP's two
    head groups' row-parallel partials summed against the whole block; at
    model 4, which cuts ViT-S's 6 heads, the four ranks' q, k and v rows
    gathered in rank order, attention over every head, each rank's columns of
    its output through its proj shard, the four partials summed against the
    whole block; SP's two query slices (785 tokens padded to 786, the pad
    masked) each absorbing both key/value slices in turn against dense
    attention."""
    import torch

    from sod_tpu_torch.models.maskformer import MaskFormer, config_from
    from sod_tpu_torch.ops.attention import _merge_heads, sdpa
    from sod_tpu_torch.ops.layers import gelu, linear
    from sod_tpu_torch.parallel.fsdp import _PACKED, model_shard
    from sod_tpu_torch.parallel.sp import absorb
    from sod_tpu_torch.parallel.tp import _row_parallel, tp_specs

    model = MaskFormer(config_from(cfg))
    model.load_state_dict(sd)
    blk = model.encoder.blocks[0].cuda()
    vcfg = model.cfg.vit
    wrap = torch.nn.ModuleList([blk])
    specs = tp_specs(wrap, 2)
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(TRAIN_B, TRAIN_N, vcfg.embed_dim, device="cuda", generator=g)
    with torch.no_grad():
        whole = blk(x)
        hd = vcfg.embed_dim // vcfg.n_heads
        shards = [{n: model_shard(p, specs[n]["model"], 2, r, bool(_PACKED.search(n)))
                   if specs[n] else p for n, p in wrap.named_parameters()} for r in range(2)]
        h, parts = blk.norm1(x), []
        for w in shards:
            y = linear(h, w["0.attn.qkv.weight"], w["0.attn.qkv.bias"])
            y = y.reshape(TRAIN_B, TRAIN_N, 3, -1, hd)
            q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
            parts.append(_row_parallel(_merge_heads(sdpa(q, k, v, hd ** -0.5)),
                                       w["0.attn.proj.weight"], None, None))
        x1 = x + ((parts[0] + parts[1]) + blk.attn.proj.bias)
        h2, parts = blk.norm2(x1), []
        for w in shards:
            u = gelu(linear(h2, w["0.mlp.fc1.weight"], w["0.mlp.fc1.bias"]))
            parts.append(_row_parallel(u, w["0.mlp.fc2.weight"], None, None))
        tp = float(((x1 + ((parts[0] + parts[1]) + blk.mlp.fc2.bias)) - whole).abs().max())
        # model 4: 96 rows of each third a rank, 1.5 heads
        specs = tp_specs(wrap, 4)
        shards = [{n: model_shard(p, specs[n]["model"], 4, r, bool(_PACKED.search(n)))
                   if specs[n] else p for n, p in wrap.named_parameters()} for r in range(4)]
        ys = [linear(h, w["0.attn.qkv.weight"], w["0.attn.qkv.bias"])
              .reshape(TRAIN_B, TRAIN_N, 3, -1) for w in shards]
        rows = ys[0].shape[-1]
        y = torch.cat(ys, -1).reshape(TRAIN_B, TRAIN_N, 3, vcfg.n_heads, hd)
        q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
        out = _merge_heads(sdpa(q, k, v, hd ** -0.5))
        parts = [_row_parallel(out[..., r * rows:(r + 1) * rows], w["0.attn.proj.weight"],
                               None, None) for r, w in enumerate(shards)]
        x1 = x + (((parts[0] + parts[1]) + parts[2]) + parts[3] + blk.attn.proj.bias)
        h2 = blk.norm2(x1)
        parts = [_row_parallel(gelu(linear(h2, w["0.mlp.fc1.weight"], w["0.mlp.fc1.bias"])),
                               w["0.mlp.fc2.weight"], None, None) for w in shards]
        tp4 = float(((x1 + (((parts[0] + parts[1]) + parts[2]) + parts[3]
                            + blk.mlp.fc2.bias)) - whole).abs().max())
        # the ring's update over two slices of 393 (the last key a pad)
        q, k, v = (torch.randn(TRAIN_B, vcfg.n_heads, TRAIN_N + 1, hd, device="cuda",
                               generator=g) for _ in range(3))
        mask = torch.ones(TRAIN_B, TRAIN_N + 1, dtype=torch.bool, device="cuda")
        mask[:, TRAIN_N:] = False
        dense = sdpa(q, k, v, hd ** -0.5, mask)
        c, sp = (TRAIN_N + 1) // 2, 0.0
        for j in range(2):
            qs = q[:, :, j * c:(j + 1) * c].float()
            m = torch.full(qs.shape[:3], -1e30, device="cuda")
            l, acc = torch.zeros_like(m), torch.zeros_like(qs)
            for i in range(2):
                sl = slice(((j - i) % 2) * c, ((j - i) % 2 + 1) * c)
                m, l, acc = absorb(qs, m, l, acc, k[:, :, sl], v[:, :, sl], mask[:, sl],
                                   hd ** -0.5)
            sp = max(sp, float((acc / l[..., None] - dense[:, :, j * c:(j + 1) * c])
                               .abs().max()))
    return tp, tp4, rows, sp


def model_layouts_check():
    """Phase 23: the model-sharding layouts (ROADMAP item 12b) on the card,
    each at one rank over NCCL with its own code running, against the run
    with no mesh in this call."""
    import torch
    import torch.distributed as dist

    import sod_tpu_torch.cli.train as cli_train
    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.parallel import (make_mesh_2d, make_mesh_3d, make_mesh_pp, make_mesh_sp,
                                        make_mesh_sptp, p3_merge_blocks, p3_split_blocks)
    from sod_tpu_torch.train.evaluator import Evaluator

    if not torch.cuda.is_available():
        raise RuntimeError("phase 23 runs the layouts over NCCL on the card")
    t0 = time.perf_counter()
    # --tp 2 on a machine with one card: sod_tpu's ValueError, no rendezvous
    try:
        cli_train.main(["--config", CONFIG, "--tp", "2"])
        raise AssertionError("cli.train --tp 2 did not raise on one card")
    except ValueError as e:
        print(f"  cli.train --tp 2 on {torch.cuda.device_count()} card(s): ValueError {e}; "
              f"process group started: {dist.is_initialized()}", flush=True)
    if dist.is_initialized():
        raise AssertionError("cli.train --tp 2 started a process group")
    base = load_config(CONFIG).replace(use_pallas_attention=False, compute_dtype="float32")
    sd = random_state_dict(MaskFormer(config_from(base)), base.seed)
    split = p3_split_blocks(sd)
    merged = p3_merge_blocks(split)
    if list(merged) != list(sd) or not all(torch.equal(merged[k], sd[k]) for k in sd):
        raise AssertionError("p3_merge_blocks(p3_split_blocks(sd)) differs from sd")
    print(f"  split {sum('.attn.qkv.' in k for k in sd)} packed qkv leaves into "
          f"{sum('.attn.q.' in k or '.attn.k.' in k or '.attn.v.' in k for k in split)}, "
          "merged back bit for bit", flush=True)
    tp_gap, tp4_gap, rows4, sp_gap = _two_rank_arithmetic(sd, base)
    print(f"  two ranks in one process, B={TRAIN_B} x {TRAIN_N} tokens, f32: TP two head "
          f"groups' row-parallel partials summed vs the whole block max_abs {tp_gap:.3g}; "
          f"TP at model 4 ({rows4} rows of q, k, v a rank: 6 heads cut), gathered q/k/v "
          f"and four proj / fc2 partials summed vs the whole block max_abs {tp4_gap:.3g}; "
          f"SP two query slices absorbing both key/value slices vs dense attention "
          f"max_abs {sp_gap:.3g} (bound {LAYOUT_SPLIT_MAX_ABS:g}) [{CARD}]", flush=True)
    if max(tp_gap, tp4_gap, sp_gap) > LAYOUT_SPLIT_MAX_ABS:
        raise AssertionError("the ranks' arithmetic differs from the whole")

    batch = _to_cuda(synthetic_batch(np.random.default_rng(23), base.batch_size,
                                     base.train_image_size, base.max_gt_masks))
    report = {}
    meshes = {"tp": lambda: make_mesh_2d(1, 1, "cuda"), "pp": lambda: make_mesh_pp(1, 1, "cuda"),
              "sp": lambda: make_mesh_sp(1, 1, "cuda"),
              "p3": lambda: make_mesh_3d(1, 1, 1, "cuda"),
              "sptp": lambda: make_mesh_sptp(1, 1, 1, "cuda")}
    try:
        ref = _layout_step(base, sd, batch, None, None)
        cfg = base.replace(pp_microbatches=2)            # the GPipe ticks with M = 2
        runs = {}
        for kind, make in meshes.items():
            mesh = make()
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the {kind} mesh runs {dist.get_backend()}, not NCCL")
            run = _layout_step(cfg, sd, batch, mesh, kind)
            w, m, r = _layout_gaps(ref, run)
            ok = (w <= LAYOUT_MAX_ABS and m <= LAYOUT_MAX_REL and r <= LAYOUT_MAX_REL
                  and not run["counts"] and not ref["counts"])
            print(f"  {kind} mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.mesh.shape)}: one f32 "
                  f"step at B={base.batch_size}, 224 px vs no mesh: weights max_abs {w:.3g} "
                  f"(bound {LAYOUT_MAX_ABS:g}), moments max_rel {m:.3g}, metrics max_rel "
                  f"{r:.3g} (bound {LAYOUT_MAX_REL:g}); loss {run['metrics']['loss']:.6g} vs "
                  f"{ref['metrics']['loss']:.6g}; port kernels launched {run['counts'] or 0} "
                  f"[{CARD}]", flush=True)
            if not ok:
                raise AssertionError(f"the {kind} layout's step differs from the step with "
                                     f"no mesh, or launched a port kernel")
            runs[kind] = run
            report[kind] = {"max_abs": w, "moments_rel": m, "metrics_rel": r}

        # step ms of each layout and of no mesh, in turns
        times = {k: [] for k in ["no mesh", *runs]}
        for _ in range(LAYOUT_ROUNDS):
            for name in times:
                run = ref if name == "no mesh" else runs[name]
                times[name].append(_timed_steps(run["step"], run["batch"], LAYOUT_TIMED_STEPS))
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"  f32 step ms at B={base.batch_size}, {LAYOUT_ROUNDS} rounds of "
              f"{LAYOUT_TIMED_STEPS} in turns (median): "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items()) + f" [{CARD}]", flush=True)
        report["step ms"] = med
        del runs, ref
        _release()

        # the SP Evaluator on the 400 px canvas (2501 tokens) against no mesh
        with tempfile.TemporaryDirectory() as root:
            write_duts_te(root, LAYOUT_EVAL_IMAGES, EVAL_SIDE // 2, EVAL_SIDE, 23)
            ev_cfg = base.replace(dir_dataset=root)
            model = MaskFormer(config_from(ev_cfg))
            model.load_state_dict(sd)
            model.cuda()
            res = {}
            for name, mesh in (("no mesh", None), ("sp", meshes["sp"]())):
                res[name] = Evaluator(model, ev_cfg, config_from(ev_cfg),
                                      batch_size=LAYOUT_EVAL_B, device="cuda",
                                      mesh=mesh)("duts")
            gap = max(abs(res["sp"][k] - res["no mesh"][k]) for k in res["no mesh"])
            print(f"  SP Evaluator, {LAYOUT_EVAL_IMAGES} images on the {EVAL_SIDE} px canvas "
                  f"(2501 tokens) at B={LAYOUT_EVAL_B}, f32: 14 metric means vs no mesh "
                  f"max_abs {gap:.3g} (bound {LAYOUT_EVAL_MAX_ABS:g}); iou "
                  f"{res['sp']['iou']:.6g} [{CARD}]", flush=True)
            if gap > LAYOUT_EVAL_MAX_ABS:
                raise AssertionError("the SP Evaluator differs from the run with no mesh")
            report["sp evaluator"] = {"max_abs": gap}
            del model
            _release()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    phase(23, "model-sharding layouts on the card (1 rank, NCCL): "
              + ", ".join(f"{k} max_abs {report[k]['max_abs']:.3g}"
                          for k in meshes) + f" vs no mesh; step ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in report["step ms"].items())
              + f"; SP Evaluator max_abs {report['sp evaluator']['max_abs']:.3g}; no port "
              f"kernel launched; --tp 2 raises on one card; {time.perf_counter() - t0:.1f} s "
              f"[{CARD}]")
    return report


# phase 24: the dryrun at one NCCL rank, its phases that one rank runs (the
# others need two or more ranks; phase 8 shards nothing on a data axis of 1,
# and asserts that it did, as the reference's does), then entry()'s flagship
# forward at full width: its K2 forward launches, each held to K2's plain
# version on the same inputs within phase 6's bounds
DRYRUN_PHASES = ("1", "2", "2b", "3", "4")
ENTRY_K2_LAUNCHES = 12
ENTRY_ROUNDS = 10


def dryrun_check() -> dict:
    """Phase 24: ``sod_tpu_torch/dryrun.py`` at one NCCL rank, then
    ``entry()`` on the card."""
    import torch
    import torch.distributed as dist

    from sod_tpu_torch import dryrun
    from sod_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    try:
        out = dryrun.run_phases(1, "cuda", phases=DRYRUN_PHASES)
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if backend != "nccl" or not set(DRYRUN_PHASES) <= set(out):
        raise AssertionError(f"the dryrun ran {sorted(out)} over {backend}")
    print(f"  dryrun at 1 NCCL rank: phases {', '.join(DRYRUN_PHASES)} match the one-device "
          f"run (loss {out['reference']['loss']:.6g}, IoU {out['reference']['iou']:.6g}); "
          f"{time.perf_counter() - t0:.1f} s [{CARD}]", flush=True)

    fn, (model, x) = dryrun.entry("cuda")
    real = fa.flash_forward_cuda
    calls = []

    def recording(q, k, v, scale, key_mask=None):
        o, m, l = real(q, k, v, scale, key_mask)
        calls.append((q, k, v, scale, key_mask, o))
        return o, m, l

    def plain(q, k, v, scale, key_mask=None):
        return fa.flash_forward_reference(q, k, v, scale, key_mask), None, None

    fn(model, x)                                        # warm-up
    torch.cuda.synchronize()
    fa.flash_forward_cuda = recording
    try:
        reset_launch_counts()
        got = fn(model, x)
        torch.cuda.synchronize()
        launches = launch_counts()["K2 fwd"]
    finally:
        fa.flash_forward_cuda = real
    worst = (0.0, 0.0, 1.0)
    for q, k, v, scale, key_mask, o in calls:
        max_abs, rel_l2, corr = errors(o, fa.flash_forward_reference(q, k, v, scale, key_mask))
        worst = (max(worst[0], max_abs), max(worst[1], rel_l2), min(worst[2], corr))
    fa.flash_forward_cuda = plain
    try:
        want = fn(model, x)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: fn(model, x), ENTRY_ROUNDS)
    finally:
        fa.flash_forward_cuda = real
    kernel_ms = cuda_ms(lambda: fn(model, x), ENTRY_ROUNDS)
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
    shapes = [tuple(t.shape) for t in got]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
    print(f"  entry(): MaskFormer(config_from(Config())) at 224 px on a zero bf16 image, "
          f"outputs {shapes}, finite {finite}; K2 forward launches {launches} (want "
          f"{ENTRY_K2_LAUNCHES}), each vs its plain version: max_abs {worst[0]:.3g} (<= "
          f"{K2_MAX_ABS}), rel_l2 {worst[1]:.3g} (<= {K2_MAX_REL_L2}), corr {worst[2]:.8f} "
          f"(> {K2_MIN_CORR}); vs the forward through the plain version: mask_pred max_abs "
          f"{gaps[0]:.3g}, objectness {gaps[1]:.3g} (printed); forward ms {kernel_ms:.2f} "
          f"kernel vs {plain_ms:.2f} plain [{CARD}]", flush=True)
    ok = (launches == ENTRY_K2_LAUNCHES and len(calls) == ENTRY_K2_LAUNCHES and finite
          and worst[0] <= K2_MAX_ABS and worst[1] <= K2_MAX_REL_L2 and worst[2] > K2_MIN_CORR
          and shapes == [(1, 6, 20, 56, 56), (1, 6, 20, 1)])
    if not ok:
        raise AssertionError("entry()'s forward did not launch K2 12 times within phase 6's "
                             "bounds of its plain version")
    del model, got, want, calls
    _release()
    phase(24, f"dryrun phases {', '.join(DRYRUN_PHASES)} at 1 NCCL rank match one device; "
              f"entry() {shapes}, {launches} K2 forward launches within phase 6's bounds, "
              f"{kernel_ms:.2f} ms vs {plain_ms:.2f} plain; "
              f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    return {"entry K2 fwd": launches, "entry ms": kernel_ms, "entry plain ms": plain_ms}


def main():
    card_check()
    import torch

    build_kernels()
    max_abs, timings = kernel_check()
    gemms = gemm_check()
    gemms_bwd = gemm_bwd_check()
    linears = linear_check()
    svc, cfg, launches, main_linears = main_path()
    try:
        requests_phase(svc, cfg)
        # beside the bf16 service while it is up
        k8_worst, k8_times, k8_bound, k8_forms = int8_kernel_check()
        k8_launches = int8_serving_check(svc, cfg)
        refine_check(svc, cfg)
        pool_check(svc, cfg)
        tools_check(svc, cfg)
    finally:
        svc.close()
    k2_worst, k2_times = k2_check()
    vitg = vitg_train_check()
    train_step_check()
    k2_launches = trainer_check()
    ev = eval_kernels_check()
    ev_counts = evaluator_check()
    tk = fused_train_kernels_check()
    step_counts, _, _ = fused_train_step_check()
    tr = fused_trainer_check()
    maskgen_check()
    model_options_check()
    training_options_check()
    data_mesh_check()
    model_layouts_check()
    dr = dryrun_check()
    fused_run, default_run = ev_counts["use_fused_eval"], ev_counts["default"]

    # bounds of K1 and K2 at the shapes they were timed at (B=8, 785 tokens)
    c = block_cost(TRAIN_B * TRAIN_N, TRAIN_B, TRAIN_N, 384, 1536)
    act = 2 * TRAIN_B * TRAIN_N * 384
    k1_bound = roofline(c["qkv"] + 2 * c["scores"] + c["proj"] + 2 * c["fc"],
                        2 * act + c["w_attn"] + c["w_mlp"])
    k2_bounds = k2_bound(*K2_TRAIN_SHAPE)
    k2_vitg = k2_bound(*K2_VITG_SHAPE)
    k2_eval = k2_times["eval"]

    def entry(kernel, n_launches, err, ms, plain_ms, bound, library_ms=None, **extra):
        return dict(kernel, launches=n_launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound, library_ms=library_ms, **extra)

    k1_ms, k1_plain_ms, k1_graph_ms = timings[8]
    report = [entry(KERNEL, launches, max_abs, k1_ms, k1_plain_ms, k1_bound,
                    graph_ms=k1_graph_ms),
              entry(K8, k8_launches, k8_worst, *k8_times[8][:2], k8_bound),
              entry(K2_FWD, k2_launches[0], k2_worst["fwd"], *k2_times["fwd"],
                    k2_bounds["fwd"], k2_times["fwd_lib"],
                    entry_launches=dr["entry K2 fwd"]),
              entry(K2_BWD, k2_launches[1], k2_worst["bwd"], *k2_times["bwd"],
                    k2_bounds["bwd"], k2_times["bwd_lib"]),
              # the same kernels at the vitg14reg-train-b8 cell's shape, launched in
              # phase 25's step
              entry(K2_FWD_VITG, vitg["K2 fwd"], k2_worst["fwd"], *k2_times["vitg"]["fwd"],
                    k2_vitg["fwd"]),
              entry(K2_BWD_VITG, vitg["K2 bwd"], k2_worst["bwd"], *k2_times["vitg"]["bwd"],
                    k2_vitg["bwd"]),
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
              entry(K6, default_run["K6"], *ev["K6"], ev["bound"]["K6"],
                    graph_ms=ev["K6 graph_ms"]),
              entry(K7, fused_run["K7"], *ev["K7"], ev["bound"]["K7"])]
    # gemm_kernel in K1's four forms at B=8 (device time, from CUDA graphs).
    # The main path launches them inside K1's chain, not through ops/gemm.py:
    # each form's launches are K1's counted launches, one per K1 launch
    for name, (err, ms, plain_ms, bound, lib_ms) in gemms.items():
        report.append(entry(dict(GEMM, name=f"gemm_{name}"), launches, err, ms, plain_ms,
                            bound, lib_ms, launches_rule="one per fused_vit_block launch"))
    # the backward forms and the LayerNorm backward at the fused train step's
    # shapes (device time, from CUDA graphs), launched inside K3's and K4's
    # backward chains: one per chain launch (the kept-hidden dgelu form under
    # fused_save_acts, phase 12's step)
    for name, (err, ms, plain_ms, bound, lib_ms, extra) in gemms_bwd.items():
        k3 = "k3" in name
        n_launches = (step_counts["fused_save_acts"]["K4 bwd"] if name.endswith("kept")
                      else tr["K3 bwd" if k3 else "K4 bwd"])
        rule = ("one per K4 backward launch under fused_save_acts" if name.endswith("kept")
                else f"one per {'K3' if k3 else 'K4'} backward launch")
        src = dict(GEMM_BWD if k3 else GEMM_BWD_K4,
                   name=name if name.startswith("ln_") else f"gemm_{name}")
        report.append(entry(src, n_launches, err, ms, plain_ms, bound, lib_ms,
                            launches_rule=rule, **extra))
    # the bf16 linear at the train cells' shapes: the f32-bias form alone
    # and linear_tc forward and backward against linear_f32 (device time,
    # from CUDA graphs).  The ViT-S shapes' count is phase 4's: the patch
    # embedding and the decoder's linears in the B=8 forward; the ViT-g
    # shapes' ("g_") phase 25's step; one f32-bias launch a call
    for name, (form, fn) in linears.items():
        if name.startswith("g_"):
            n_tc, calls = vitg["tc"], {"vitg14reg step": vitg["tc"]}
            rule = "ops/layers.py tc_linears in phase 25's vitg14reg-train-b8 step"
        else:
            n_tc, calls = main_linears["forward B=8"], main_linears
            rule = "ops/layers.py tc_linears"
        report.append(entry(dict(LINEAR, name=f"gemm_f32bias_{name}"), n_tc, *form,
                            launches_rule="one per linear_tc call", main_path_calls=calls))
        report.append(entry(dict(LINEAR, name=f"linear_tc_{name}"), n_tc, *fn[:5],
                            launches_rule=rule, main_path_calls=calls, **fn[5]))
    # K8's s8 products alone at B=8 (device time, from CUDA graphs), launched
    # inside K8's chain: one of each per K8 launch
    for name, (err, ms, plain_ms, bound, lib_ms) in k8_forms.items():
        report.append(entry(dict(S8, name=f"gemm_s8_{name}"), k8_launches, err, ms, plain_ms,
                            bound, lib_ms, launches_rule="one per fused_vit_block_int8 launch"))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
