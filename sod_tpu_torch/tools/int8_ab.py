"""Hold K8's and K7's results of two or more checkouts against each other,
bit for bit, on identical seeded inputs.

    python3 -m sod_tpu_torch.tools.int8_ab PARENT_DIR . [--out DIR]

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each runs in a
fresh process with its checkout as its working directory and saves, to
DIR/<i>.pt (default DIR: ``sod_tpu_torch/_build/int8_ab``, git-ignored):

* K8 (``fused_vit_block_int8`` with its scratch) at the served shape (B=8,
  896 tokens of which 785 real, d 384, 6 heads), unmasked and masked, and
  on 200 of 256 tokens at d 768 (12 heads) and d 192 (3 heads): the output
  and the codes and row scales of its four quantisers;
* K7 (``ub_inter_cnt``) at the eval shape, masks [16, 20, 100, 100] to a
  400 px canvas with valid rectangles of 200-400 px: both counts.

Each process prints one JSON line: per K8 case the output's max_abs against
its plain version on the real tokens and the codes that differ from the
plain version's per quantiser; K7's (image, query) pairs whose counts
differ from the plain version's.  Then every saved tensor is compared with
the first checkout's and the elements that differ are printed (0: equal).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# (name, batch, padded tokens, real tokens, width, heads, key mask)
K8_CASES = (("b8_unmasked", 8, 896, 785, 384, 6, False), ("b8_masked", 8, 896, 785, 384, 6, True),
            ("d768", 2, 256, 200, 768, 12, True), ("d192", 2, 256, 200, 192, 3, True))
MATS = ("qkv", "proj", "fc1", "fc2")


def _block_state(rng, d: int) -> dict:
    """One block's f32 state dict (``blocks.0.*``): N(0, 0.02) weights,
    random biases and LayerNorm parameters."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    state = {}
    for name, (n, k) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                         "mlp.fc1": (4 * d, d), "mlp.fc2": (d, 4 * d)}.items():
        state[f"blocks.0.{name}.weight"] = t(rng.normal(0, 0.02, (n, k)))
        state[f"blocks.0.{name}.bias"] = t(rng.normal(0, 0.02, n))
    for name in ("norm1", "norm2"):
        state[f"blocks.0.{name}.weight"] = t(1 + rng.normal(0, 0.1, d))
        state[f"blocks.0.{name}.bias"] = t(rng.normal(0, 0.1, d))
    return state


def measure(out_path: str) -> dict:
    """Run K8 and K7 of the checkout in the working directory; save their
    results to ``out_path``; return the summary against the plain versions."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from sod_tpu_torch.ops import fused_block_int8 as fq
    from sod_tpu_torch.ops import fused_ub

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(14)
    saved, summary = {}, {}
    with torch.inference_mode():
        for name, b, n, n_real, d, h, masked in K8_CASES:
            bq = fq.quantize_vit_blocks(_block_state(rng, d), prefix="blocks.", device="cuda")[0]
            x = torch.from_numpy(rng.standard_normal((b, n, d), np.float32)).to(
                device="cuda", dtype=torch.bfloat16)
            mask = None
            if masked:
                mask = torch.from_numpy(rng.random((b, n)) > 0.3).cuda()
                mask[:, 0] = True
            sk, sr = {}, {}
            out = fq.fused_vit_block_int8(x, bq, h, n_real, key_mask=mask, scratch=sk)
            ref = fq.fused_vit_block_int8_reference(x, bq, h, n_real, key_mask=mask, scratch=sr)
            saved[f"{name}/out"] = out.cpu()
            flips = {}
            for st in MATS:
                saved[f"{name}/q_{st}"] = sk[f"q_{st}"].cpu()
                saved[f"{name}/s_{st}"] = sk[f"s_{st}"].cpu()
                flips[st] = int((sk[f"q_{st}"] != sr[f"q_{st}"]).sum())
            summary[name] = {"max_abs": float((out[:, :n_real].float()
                                               - ref[:, :n_real].float()).abs().max()),
                             "codes_differ": flips}
        b, side, q = 16, 400, 20
        low = torch.from_numpy(1 / (1 + np.exp(-3 * rng.standard_normal(
            (b, q, side // 4, side // 4)))).astype(np.float32)).cuda()
        gt = torch.from_numpy((rng.random((b, side, side)) > 0.5).astype(np.float32)).cuda()
        sizes = rng.integers(side // 2, side + 1, (b, 2))
        rowv = torch.from_numpy(np.arange(side)[None] < sizes[:, :1]).cuda()
        colv = torch.from_numpy(np.arange(side)[None] < sizes[:, 1:]).cuda()
        got = fused_ub.ub_inter_cnt(low, gt, rowv, colv)
        ref = fused_ub.ub_inter_cnt_reference(low, gt, rowv, colv)
        saved["k7/inter"], saved["k7/cnt"] = got[0].cpu(), got[1].cpu()
        summary["k7_pairs_differ"] = int(((got[0] != ref[0]) | (got[1] != ref[1])).sum())
    torch.save(saved, out_path)
    return summary


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps({"tree": os.getcwd(), **measure(args[1])}), flush=True)
        return
    out = "sod_tpu_torch/_build/int8_ab"
    if "--out" in args:
        i = args.index("--out")
        out, args = args[i + 1], args[:i] + args[i + 2:]
    if not args:
        raise SystemExit(__doc__)
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    paths = [os.path.join(out, f"{i}.pt") for i in range(len(args))]
    for d, path in zip(args, paths):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", path],
                       cwd=d, check=True, timeout=900)
    import torch

    first = torch.load(paths[0])
    for d, path in zip(args[1:], paths[1:]):
        other = torch.load(path)
        differ = {k: int((first[k] != other[k]).sum()) for k in first}
        print(json.dumps({"against": args[0], "tree": d, "elements_that_differ": differ,
                          "all_equal": not any(differ.values())}), flush=True)


if __name__ == "__main__":
    main()
