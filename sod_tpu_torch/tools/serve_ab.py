"""Time the bf16 service of two or more checkouts in turns.

    python3 -m sod_tpu_torch.tools.serve_ab PARENT_DIR .

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  They run in
the order given and then in reverse (A B B A), each in a fresh process
with the checkout as its working directory, so that host-bound readings
are compared on one machine within one run.  Each process builds the service at
the shipped config's full width with seeded weights and prints one JSON
line: B=1 latency (ms) and B=8 img/s on the host clock, three rounds each;
K1's eager ms a call at B=1 and B=8; and K1's wrapper's host time a call
(us) over 100 calls issued without waiting.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def measure(tag: str) -> dict:
    """The readings of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sod_tpu_torch.config import load_config
    from sod_tpu_torch.ops import fused_block as fb
    from sod_tpu_torch.serving.inference import SelfMaskInference

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(cs.CONFIG)
    svc = SelfMaskInference(cfg=cfg, device="cuda")
    rng = np.random.default_rng(1)
    size = cfg.eval_image_size
    one = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    res = {"tree": tag}
    for rep in range(3):
        res[f"b1_ms_{rep}"] = cs.host_ms(lambda: svc.forward_u8(one), 40)
        res[f"b8_ips_{rep}"] = 8e3 / cs.host_ms(lambda: svc.forward_u8(batch), 25)
    blk = cs.make_block(rng, 384, 6, True)
    with torch.inference_mode():
        for bb in (1, 8):
            xb = torch.from_numpy(rng.standard_normal((bb, 896, 384), np.float32)).to(
                device="cuda", dtype=torch.bfloat16)
            kern = lambda: fb.fused_vit_block(xb, blk, 6, 785)  # noqa: E731
            res[f"k1_b{bb}_eager"] = (cs.cuda_ms(kern, 50) + cs.cuda_ms(kern, 50)) / 2
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(100):
                kern()
            res[f"k1_b{bb}_host_us_per_call"] = (time.perf_counter() - t) / 100 * 1e6
            torch.cuda.synchronize()
    svc.close()
    return res


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps(measure(args[1])), flush=True)
        return
    if not args:
        raise SystemExit(__doc__)
    for d in args + args[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", d],
                       cwd=d, check=True, timeout=900)


if __name__ == "__main__":
    main()
