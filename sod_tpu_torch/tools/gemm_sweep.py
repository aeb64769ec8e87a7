"""Time every configuration of ``gemm_kernel`` and every column split at the
shapes of ``chip_smoke.py`` phase 3 (and K1's d 768 and d 1024 forms at 512
rows), beside the plan ``gemm_plan`` makes.

    python3 -m sod_tpu_torch.tools.gemm_sweep [OUT.jsonl]

The library takes no configuration from its caller, so the tool copies the
port's package and ``chip_smoke.py`` into the git-ignored
``sod_tpu_torch/_build/sweep/``, makes ``launch_gemm`` there read one from
the environment variable ``SOD_GEMM_FORCE`` ("config,tiles", the indices of
``ops/gemm.py`` ``CONFIGS``), and runs the sweep from that copy.  It writes
one JSON line per shape (default ``sod_tpu_torch/_build/gemm_sweep.jsonl``):
the plan and its ms, and for each configuration and split its ms (CUDA
graphs) and its largest difference from the plan's output; and prints each
shape's plan beside its fastest configuration.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PLAN_LINE = ("    const GemmPlan p = gemm_plan(LN, M, N, K);\n"
             "    if (p.config < 0) return cudaErrorInvalidValue;")
FORCED = ("    GemmPlan p = gemm_plan(LN, M, N, K);\n"
          "    if (const char* f = getenv(\"SOD_GEMM_FORCE\")) {\n"
          "        int c = 0, t = 0;\n"
          "        if (sscanf(f, \"%d,%d\", &c, &t) == 2) p = GemmPlan{c, t};\n"
          "    }\n"
          "    if (p.config < 0) return cudaErrorInvalidValue;")


def make_copy() -> str:
    """The package and chip_smoke.py under _build/sweep, launch_gemm patched."""
    dst = os.path.join(REPO, "sod_tpu_torch", "_build", "sweep")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "sod_tpu_torch"), os.path.join(dst, "sod_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)
    path = os.path.join(dst, "sod_tpu_torch", "csrc", "vit_block.cuh")
    with open(path) as f:
        src = f.read()
    if PLAN_LINE not in src:
        raise RuntimeError("launch_gemm's plan line not found: update gemm_sweep.py")
    src = src.replace(PLAN_LINE, FORCED).replace(
        "#include <algorithm>\n",
        "#include <algorithm>\n#include <cstdio>\n#include <cstdlib>\n", 1)
    with open(path, "w") as f:
        f.write(src)
    return dst


def shapes():
    import chip_smoke as cs

    out = [(form, m) for m in cs.GEMM_ROWS for form in cs.GEMM_FORMS]
    for d in (768, 1024):
        for name, epi, ln, a_t, res_t, _, _ in cs.GEMM_FORMS:
            n = {"qkv": 3 * d, "proj": d, "fc1": 4 * d, "fc2": d}[name]
            k = 4 * d if name == "fc2" else d
            out.append(((name, epi, ln, a_t, res_t, n, k), 512))
    return out


def sweep(out_path: str) -> None:
    """Run from the patched copy (its root is the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sod_tpu_torch.ops import gemm as G

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)

    def mk(shape, dtype, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale).to(
            device="cuda", dtype=getattr(torch, dtype))

    total = {"plan": 0.0, "best": 0.0}
    with open(out_path, "w") as out:
        for (name, epi, ln, a_t, res_t, n, k), m in shapes():
            a = mk((m, k), a_t)
            w, bias = mk((n, k), "bfloat16", 0.02), mk((n,), "bfloat16", 0.02)
            lnp = ((1 + mk((k,), "float32", 0.1)).to(torch.bfloat16),
                   mk((k,), "bfloat16", 0.1)) if ln else None
            res = mk((m, n), res_t) if res_t else None
            run = lambda: G.gemm(a, w, bias, epi, ln=lnp, res=res)  # noqa: E731
            os.environ.pop("SOD_GEMM_FORCE", None)
            ref = run()
            rec = {"form": name, "M": m, "N": n, "K": k, "plan": G.plan(ln, m, n, k),
                   "plan_ms": cs.graph_ms(run, 10, 3), "times": {}}
            for c, cfg in enumerate(G.CONFIGS):
                cols = int(cfg.rsplit("x", 1)[1])
                if n % cols:
                    continue
                n_ct = n // cols
                for t in sorted({-(-n_ct // g) for g in range(1, n_ct + 1)}):
                    os.environ["SOD_GEMM_FORCE"] = f"{c},{t}"
                    try:
                        diff = float((run().float() - ref.float()).abs().max())
                        rec["times"][f"{cfg},{t}"] = [cs.graph_ms(run, 10, 3), diff]
                    except RuntimeError as e:       # does not fit, or no LN form of it
                        rec["times"][f"{cfg},{t}"] = [None, str(e)[:60]]
                    torch.cuda.synchronize()
            os.environ.pop("SOD_GEMM_FORCE", None)
            out.write(json.dumps(rec) + "\n")
            best = min((v[0], key) for key, v in rec["times"].items() if v[0])
            total["plan"] += rec["plan_ms"]
            total["best"] += best[0]
            print(f"{name:4s} M {m:5d} N {n:4d} K {k:4d}: plan {rec['plan']} "
                  f"{rec['plan_ms']:.4f} ms, fastest {best[1]} {best[0]:.4f} ms", flush=True)
            torch.cuda.empty_cache()
    print(f"sum over the shapes: plan {total['plan']:.4f} ms, fastest {total['best']:.4f} ms")


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--in-copy"]:
        sweep(args[1])
        return
    out = os.path.abspath(args[0] if args else os.path.join(REPO, "sod_tpu_torch", "_build",
                                                             "gemm_sweep.jsonl"))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    dst = make_copy()
    subprocess.run([sys.executable, os.path.join(dst, "sod_tpu_torch", "tools", "gemm_sweep.py"),
                    "--in-copy", out], cwd=dst, check=True, timeout=1800)


if __name__ == "__main__":
    main()
