#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sod_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as it passes; any failure exits non-zero:

1. card: a CUDA device of compute capability 9.0, its name and power limit
   from nvidia-smi; TF32 off for the plain versions;
2. build: nvcc builds both kernel libraries from the checkout, in parallel
   (the fused ViT block K1, flash attention K2);
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
   (dq, dk, dv) against their plain versions at the train shape (B 8,
   6 heads, 785 tokens, head dim 64) and at head dims 32 and 128; forward
   and backward timed against the plain versions with CUDA events;
7. train step: the live config at full width with seeded weights, one
   step through the kernels and one from the same weights and batch
   through the plain versions: loss, grad norm and update agreement, 12
   K2 launches each way per step, step time and img/s both ways, and the
   device's idle share over a profiled step;
8. Trainer: ``python -m sod_tpu_torch.cli.train``'s ``main`` on a
   64-image synthetic DUTS directory (RLE pseudo masks, yaml) for 2
   epochs, ``latest_model.pt``, then ``--resume`` for a third; then a
   learning check (scripts/learning_check.py's synthetic task, 300 steps,
   lr 2e-5, warmup steps/5, monotone poly): eval IoU must exceed 0.8.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.  Needs no network and no jax.
"""
from __future__ import annotations

import contextlib
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


def build_kernels():
    """Both libraries at once: one nvcc per source, started together."""
    from sod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    errors = []

    def build(name):
        try:
            _build.load(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,))
               for n in ("fused_block", "flash_attention")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name in ("fused_block", "flash_attention"):
        print("\n".join(ptxas_report(_build.library_path(name) + ".log")))
    phase(2, f"built {KERNEL['source']} and {K2['source']} in "
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


def make_block(rng, d: int, n_heads: int, perturbed: bool):
    """A ViT-S block on the card, weights drawn as sod_tpu's vit_init draws
    them (N(0, 0.02) linears, zero biases, LayerNorm ones and zeros); with
    ``perturbed``, biases and LayerNorm parameters are random too, so a
    misplaced bias or LN parameter shows."""
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
    return blk.to(device="cuda", dtype=torch.bfloat16)


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
    version in place of the kernel (for the ``encoder_apply`` hook)."""
    import torch.nn.functional as F

    from sod_tpu_torch.models.vit import LN_EPS, prepare_tokens
    from sod_tpu_torch.ops.fused_block import fused_vit_block_reference

    tokens, _ = prepare_tokens(vit, x)
    n = tokens.shape[1]
    out = F.pad(tokens, (0, 0, 0, -(-n // 128) * 128 - n))
    for blk in vit.blocks:
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


def main_path():
    import torch

    from sod_tpu.config import load_config
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

    def timed(fn, iters):
        fn()
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return float(np.median(ts)) * 1e3

    one = imgs[:1]

    def plain_fwd(u8):
        with torch.inference_mode():
            svc.model(svc.prep(torch.from_numpy(u8).cuda()),
                      encoder_apply=plain_encoder)

    lat = {"kernel B=1 ms": timed(lambda: svc.forward_u8(one), 30),
           "plain B=1 ms": timed(lambda: plain_fwd(one), 10),
           "model_step B=1 ms": timed(lambda: svc.model_step(imgs[0]), 30)}
    b8 = timed(lambda: svc.forward_u8(batch), 20)
    p8 = timed(lambda: plain_fwd(batch), 5)
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
    import base64

    from PIL import Image

    from sod_tpu_torch.ops import fused_block as fb

    from sod_tpu.serving.app import create_app
    from sod_tpu.serving.db import Database

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
        before = fb.launches
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
        if fb.launches - before != 3 * svc.mcfg.vit.depth:
            raise AssertionError(f"/predict launched the kernel "
                                 f"{fb.launches - before} times for 3 requests")
    phase(5, "3 /predict requests answered through the port's service")


# K2 vs its plain versions at the train shape (bf16 outputs of magnitude
# < 1): both round at the same points, so they differ by single bf16 ulp
# flips from f32 sums taken in another order (first H100 run: max_abs
# forward 0.00098, dq 0.00049, dk 0.00195, dv 0.00098; rel_l2 <= 1.6e-4;
# corr >= 0.99999999)
K2_MAX_ABS, K2_MAX_REL_L2, K2_MIN_CORR = 0.0078125, 1e-3, 0.99999


def _k2_inputs(rng, shape):
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(device="cuda", dtype=torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.5
                          ).to(device="cuda", dtype=torch.bfloat16)
    mask = torch.from_numpy(rng.random((shape[0], shape[2])) > 0.3).cuda()
    mask[:, 0] = True
    return q, k, v, do, mask


def k2_check():
    """Phase 6: returns the worst forward and backward max_abs and the
    train-shape times {name: (kernel ms, plain ms)}."""
    import torch

    from sod_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(6)
    worst = {"fwd": 0.0, "bwd": 0.0}

    def check(name, kind, got, ref):
        max_abs, rel_l2, corr = errors(got, ref)
        ok = (bool(torch.isfinite(got).all()) and max_abs <= K2_MAX_ABS
              and rel_l2 <= K2_MAX_REL_L2 and corr > K2_MIN_CORR)
        print(f"  {name}: max_abs {max_abs:.6g} rel_l2 {rel_l2:.6g} corr "
              f"{corr:.9f} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version ({name})")
        worst[kind] = max(worst[kind], max_abs)

    for shape in ((8, 6, 785, 64), (2, 4, 130, 32), (2, 2, 100, 128)):
        q, k, v, do, mask = _k2_inputs(rng, shape)
        scale = shape[-1] ** -0.5
        tag = f"B{shape[0]} H{shape[1]} N{shape[2]} d{shape[3]}"
        o, m, l = fa.flash_forward_cuda(q, k, v, scale)
        om, _, _ = fa.flash_forward_cuda(q, k, v, scale, mask)
        grads = fa.flash_backward_cuda(q, k, v, do, m, l, scale)
        torch.cuda.synchronize()
        check(f"{tag} forward", "fwd", o, fa.flash_forward_reference(q, k, v, scale))
        check(f"{tag} forward masked", "fwd", om,
              fa.flash_forward_reference(q, k, v, scale, mask))
        for gname, got, ref in zip(("dq", "dk", "dv"), grads,
                                   fa.flash_backward_reference(q, k, v, do, scale)):
            check(f"{tag} backward {gname}", "bwd", got, ref)

    q, k, v, do, _ = _k2_inputs(rng, (8, 6, 785, 64))
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
    phase(6, f"K2 forward and backward match their plain versions (max_abs "
             f"<= {K2_MAX_ABS}, rel_l2 <= {K2_MAX_REL_L2}, corr > {K2_MIN_CORR})")
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

    from sod_tpu.config import load_config
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


def profile_steps(step, batch, n: int, step_ms: float):
    """torch.profiler over ``n`` steps: device busy ms per step (sum of the
    CUDA kernels' times; one stream, so no overlap) and the idle share
    against ``step_ms``, the step's time with the profiler off (the
    profiler's own host cost stretches the profiled steps)."""
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
    print(f"  profile over {n} steps: device busy {busy:.3f} ms/step, idle "
          f"share {idle:.3f} of the {step_ms:.3f} ms unprofiled step "
          f"(profiled wall {wall:.3f} ms/step), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/step", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
              f"x{e.count // n:<5d} {e.key[:90]}")
    groups = {"K2 (flash_*)": ("flash_",), "GEMMs": ("gemm", "xmma", "cutlass"),
              "copies and casts": ("copy",)}
    shares = {g: 0.0 for g in (*groups, "other")}
    for e in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), "other")
        shares[g] += e.self_device_time_total / 1e3 / n
    print("  device time by kind: " + ", ".join(
        f"{g} {v:.3f} ms ({v / busy:.1%})" for g, v in shares.items()))
    return {"busy_ms": busy, "idle_share": idle}


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


def trainer_check():
    """Phase 8: the CLI for 2 epochs, then --resume for a third; returns
    the K2 launch counts of the CLI's two epochs and the phase's times."""
    import torch
    import yaml

    from sod_tpu_torch.cli import train as cli
    from sod_tpu_torch.ops import flash_attention as fa

    times = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        with open(CONFIG) as f:
            settings = yaml.safe_load(f)
        pm = write_duts(root, 64, settings["train_image_size"])
        settings.update(dir_ckpt=os.path.join(root, "ckpt"), dir_dataset=root,
                        pseudo_masks_fp=pm, n_epochs=2)
        fp = os.path.join(root, "train.yaml")
        with open(fp, "w") as f:
            yaml.safe_dump(settings, f)
        times["dataset"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fa.fwd_launches = fa.bwd_launches = 0
        cli.main(["--config", fp, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = (fa.fwd_launches, fa.bwd_launches)
        times["cli 2 epochs"] = time.perf_counter() - t0
        steps = 2 * 64 // settings["batch_size"]
        depth = 12                               # ViT-S blocks
        print(f"  K2 launches over {steps} steps: forward {launches[0]}, "
              f"backward {launches[1]}", flush=True)
        if launches != (depth * steps, depth * steps):
            raise AssertionError(f"expected {depth * steps} K2 launches each way")
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
    iou0, iou1 = learning_check(300, 224)
    times["learning check"] = time.perf_counter() - t0
    print("  " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()), flush=True)
    if not iou1 > 0.8:
        raise AssertionError(f"learning check failed: eval IoU {iou1}")
    phase(8, f"Trainer via cli.train: 2 epochs, latest_model.pt, resume; "
             f"learning check eval IoU {iou0:.3f} -> {iou1:.3f} in 300 steps")
    return launches


def learning_check(steps: int, size: int):
    """scripts/learning_check.py on the port: the live model and loss, a
    synthetic saliency task (bright box on a dark ground, images in
    [0, 1]), lr 2e-5 with a steps/5 warmup and a monotone poly decay."""
    import torch

    from sod_tpu.config import Config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg = Config(batch_size=8, lr=2e-5, lr_warmup_duration=1, n_epochs=10)
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

    def eval_iou(bt):
        with torch.no_grad():
            out = model(bt["image"].to(torch.bfloat16))
        best = out["objectness"][:, -1, :, 0].argmax(-1)
        pred = out["mask_pred"][:, -1][torch.arange(8), best] > 0.5   # [8, s/4, s/4]
        gt = bt["gt_masks"][:, 0, 2::4, 2::4] > 0.5
        inter = (pred & gt).sum((-1, -2)).float()
        union = (pred | gt).sum((-1, -2)).float()
        return float((inter / (union + 1e-7)).mean())

    eval_batch = batch(np.random.default_rng(999))
    iou0 = eval_iou(eval_batch)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        m = step(batch(rng))
        if i % 50 == 0:
            print(f"  learning check step {i}: loss {float(m['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return iou0, eval_iou(eval_batch)


def main():
    card_check()
    import torch

    build_kernels()
    max_abs, timings = kernel_check()
    svc, cfg, launches = main_path()
    try:
        requests_phase(svc, cfg)
    finally:
        svc.close()
    k2_worst, k2_times = k2_check()
    train_step_check()
    k2_launches = trainer_check()
    report = [dict(KERNEL, launches=launches, max_abs_err=max_abs,
                   ms=timings[1][0], plain_ms=timings[1][1]),
              dict(K2_FWD, launches=k2_launches[0], max_abs_err=k2_worst["fwd"],
                   ms=k2_times["fwd"][0], plain_ms=k2_times["fwd"][1]),
              dict(K2_BWD, launches=k2_launches[1], max_abs_err=k2_worst["bwd"],
                   ms=k2_times["bwd"][0], plain_ms=k2_times["bwd"][1])]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
