"""Time every configuration of ``gemm_kernel`` and every column split (and,
for the row-contracting TN form, every split of the contracted rows) at the
shapes of ``chip_smoke.py`` phase 3, forward and backward (and K1's d 768 and
d 1024 forward forms at 512 rows), beside the plan the kernel makes.

    python3 -m sod_tpu_torch.tools.gemm_sweep [OUT.jsonl]

The library takes no configuration from its caller, so the tool copies the
port's package and ``chip_smoke.py`` into the git-ignored
``sod_tpu_torch/_build/sweep/``, makes ``plan_for`` there read one from the
environment variable ``SOD_GEMM_FORCE`` ("config,tiles,split": the index of
``ops/gemm.py`` ``CONFIGS``, the column tiles per block, the contracted rows
per split of a TN product), and runs the sweep from that copy.  It writes
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
PLAN_LINE = ("    const GemmPlan p = LAY == L_TN ? gemm_tn_plan(M, N, K) : gemm_plan(ln, M, N, K, kind);\n"
             "    return p;")
FORCED = ("    GemmPlan p = LAY == L_TN ? gemm_tn_plan(M, N, K) : gemm_plan(ln, M, N, K, kind);\n"
          "    if (const char* f = getenv(\"SOD_GEMM_FORCE\")) {\n"
          "        int c = 0, t = 0, s = 0;\n"
          "        if (sscanf(f, \"%d,%d,%d\", &c, &t, &s) == 3) p = GemmPlan{c, t, s};\n"
          "    }\n"
          "    return p;")
# the contracted-row splits tried for a TN product
TN_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16)


def make_copy() -> str:
    """The package and chip_smoke.py under _build/sweep, plan_for patched."""
    dst = os.path.join(REPO, "sod_tpu_torch", "_build", "sweep")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "sod_tpu_torch"), os.path.join(dst, "sod_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)
    path = os.path.join(dst, "sod_tpu_torch", "csrc", "vit_block.cuh")
    with open(path) as f:
        src = f.read()
    if PLAN_LINE not in src:
        raise RuntimeError("plan_for's plan line not found: update gemm_sweep.py")
    src = src.replace(PLAN_LINE, FORCED).replace(
        "#include <algorithm>\n",
        "#include <algorithm>\n#include <cstdio>\n#include <cstdlib>\n", 1)
    with open(path, "w") as f:
        f.write(src)
    return dst


def shapes():
    """(name, layout, M, N, K, forward form or backward epilogue) of every
    shape swept: the forward forms at phase 3's rows and at d 768 / 1024,
    then the backward forms (TN's M, N, K: the output's rows and columns and
    the contracted rows)."""
    import chip_smoke as cs

    out = [(form[0], "nt", m, form[5], form[6], form) for m in cs.GEMM_ROWS
           for form in cs.GEMM_FORMS]
    for d in (768, 1024):
        for form in cs.GEMM_FORMS:
            name = form[0]
            n = {"qkv": 3 * d, "proj": d, "fc1": 4 * d, "fc2": d}[name]
            k = 4 * d if name == "fc2" else d
            out.append((name, "nt", 512, n, k, form[:5] + (n, k)))
    for name, layout, rows, n, k, epi in cs.GEMM_BWD_FORMS:
        if layout == "tn":
            out.append((name, "tn", n, k, rows, None))
        else:
            out.append((name, "nn", rows, n, k, epi))
    return out


def candidates(layout: str, n: int, k: int, configs):
    """(config, tiles, split) to try: every configuration whose columns
    divide N, every column split (NT, NN) or contracted-row split (TN)."""
    for c, cfg in enumerate(configs):
        cols = int(cfg.rsplit("x", 1)[1])
        if n % cols or (layout == "tn" and cfg.startswith("panel")):
            continue
        if layout == "tn":
            for s in TN_SPLITS:
                yield c, 1, (-(-k // s) + 63) // 64 * 64
        else:
            n_ct = n // cols
            for t in sorted({-(-n_ct // g) for g in range(1, n_ct + 1)}):
                yield c, t, 0


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

    def first(t):
        return t[0] if isinstance(t, tuple) else t

    total = {"plan": 0.0, "best": 0.0}
    with open(out_path, "w") as out:
        for name, layout, m, n, k, form in shapes():
            if layout == "nt":
                _, epi, ln, a_t, res_t, _, _ = form
                a = mk((m, k), a_t)
                w, bias = mk((n, k), "bfloat16", 0.02), mk((n,), "bfloat16", 0.02)
                lnp = ((1 + mk((k,), "float32", 0.1)).to(torch.bfloat16),
                       mk((k,), "bfloat16", 0.1)) if ln else None
                res = mk((m, n), res_t) if res_t else None
                run = lambda: G.gemm(a, w, bias, epi, ln=lnp, res=res)  # noqa: E731
                plan = G.plan(ln, m, n, k)
            elif layout == "nn":
                a, w = mk((m, k), "bfloat16", 0.5), mk((k, n), "bfloat16", 0.02)
                pre = ((mk((m, k), "bfloat16"), mk((n, k), "bfloat16", 0.1),
                        mk((n,), "bfloat16", 0.1)) if form == "dgelu" else None)
                run = lambda: first(G.gemm_nn(a, w, form, pre))  # noqa: E731
                plan = G.plan(False, m, n, k, "nn", "recomputed" if form == "dgelu" else None)
            else:
                a, b = mk((k, m), "bfloat16", 0.5), mk((k, n), "bfloat16", 0.5)
                run = lambda: G.gemm_tn(a, b)  # noqa: E731
                plan = G.plan(False, m, n, k, "tn")
            os.environ.pop("SOD_GEMM_FORCE", None)
            ref = run()
            rec = {"form": name, "layout": layout, "M": m, "N": n, "K": k, "plan": plan,
                   "plan_ms": cs.graph_ms(run, 10, 3), "times": {}}
            for c, t, s in candidates(layout, n, k, G.CONFIGS):
                key = f"{G.CONFIGS[c]},{t},{s}"
                os.environ["SOD_GEMM_FORCE"] = f"{c},{t},{s}"
                try:
                    diff = float((run().float() - ref.float()).abs().max())
                    rec["times"][key] = [cs.graph_ms(run, 10, 3), diff]
                except RuntimeError as e:       # does not fit, or no LN form of it
                    rec["times"][key] = [None, str(e)[:60]]
                torch.cuda.synchronize()
            os.environ.pop("SOD_GEMM_FORCE", None)
            out.write(json.dumps(rec) + "\n")
            best = min((v[0], key) for key, v in rec["times"].items() if v[0])
            total["plan"] += rec["plan_ms"]
            total["best"] += best[0]
            print(f"{name:9s} {layout} M {m:5d} N {n:4d} K {k:4d}: plan {rec['plan']} "
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
                    "--in-copy", out], cwd=dst, check=True, timeout=2400)


if __name__ == "__main__":
    main()
