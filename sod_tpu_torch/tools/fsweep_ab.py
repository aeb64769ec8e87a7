"""Time K6 (``fmax_tp_cnt``) of two or more checkouts on one card, in turns,
and locate the time of this checkout's kernel.

    python3 -m sod_tpu_torch.tools.fsweep_ab PARENT_DIR . [--rounds 2]

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  The checkouts
run in turns (A B B A for two), each in a fresh process with its checkout as
its working directory, which builds its own ``csrc/fsweep.cu`` and prints
one JSON line: its counts against its plain version (elements that differ)
and its ms per call, eager (CUDA events around 50 calls) and from a CUDA
graph of 20 calls, at

* ``eval``: masks [16, 2, 400, 400] with valid rectangles of 200-400 px (a
  fifth of the values on the thresholds), phase 9's case;
* ``full16`` / ``full4``: every pixel valid, B = 16 and 4 on 400 px.

Then, for the checkout in the working directory only, variants of its
kernel built from a copy of the source and cut down (``_variant_sources``:
the launch alone, the setup, the loads without the counting, with and
without the ticket, everything but the finish), timed from CUDA graphs on
``full16`` and ``full4`` beside the whole kernel: where its time goes.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

CASES = ("eval", "full16", "full4")


def _inputs(case: str):
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    b = 4 if case == "full4" else 16
    side = 400
    masks = rng.random((b, 2, side, side), dtype=np.float32)
    sizes = np.full((b, 2), side)
    if case == "eval":
        from sod_tpu_torch.ops import fsweep

        table = fsweep.threshold_table(255, "cpu").numpy()
        on = rng.random(masks.shape) < 0.2
        masks[on] = table[rng.integers(0, 255, int(on.sum()))]
        sizes = rng.integers(side // 2, side + 1, (b, 2))
        sizes[0] = side
    gt = (rng.random((b, side, side)) > 0.5).astype(np.float32)
    rowv = np.arange(side)[None] < sizes[:, :1]
    colv = np.arange(side)[None] < sizes[:, 1:]
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (masks, gt, rowv, colv)]


def _graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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


def _eager_ms(fn, iters: int = 50) -> float:
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


def measure() -> dict:
    """K6 of the checkout in the working directory: differences from its
    plain version and times per case."""
    sys.path.insert(0, os.getcwd())
    import torch

    from sod_tpu_torch.ops import fsweep

    out = {}
    for case in CASES:
        args = _inputs(case)
        got = fsweep.fmax_tp_cnt(*args)
        ref = fsweep.fmax_tp_cnt_reference(*args)
        differ = sum(int((g != r).sum()) for g, r in zip(got, ref))
        fn = lambda: fsweep.fmax_tp_cnt(*args)                      # noqa: E731
        out[case] = {"differ": differ, "eager_ms": _eager_ms(fn), "graph_ms": _graph_ms(fn)}
        torch.cuda.synchronize()
    return out


def _variant_sources(src: str) -> dict:
    """The kernel whole and cut down, each cut keeping what comes before it:
    ``launch`` returns at once; ``setup`` after the row lists, the first
    copies and the zeroed histograms; ``loads`` after the last step with the
    counting cut out (a sum keeps the loads alive); ``loads_ticket`` also
    writes the band's histograms and takes the ticket; ``no_finish`` counts
    but skips the last block's finish."""
    entry = "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
    setup = "    for (int i = tid; i < HISTS * M * NB; i += THREADS) hist[i] = 0u;\n    __syncthreads();\n"
    atomics = "if (inc[m][e]) atomicAdd(&wh[m * NB + k[m][e] - 1], inc[m][e]);"
    loop = "    for (int it = 0; it < steps; ++it) {"
    after = "    cp_async_wait<0>();\n    __syncthreads();\n"
    finish = "if (!last) return;"
    for piece in (entry, setup, atomics, loop, after, finish):
        if piece not in src:
            raise SystemExit(f"fsweep_ab: csrc/fsweep.cu no longer has {piece!r}")
    stop = "    if (blockIdx.x >= 0) return;\n"
    no_count = (src.replace(atomics, "sink += p[m][e] + (float)gb[e];")
                .replace(loop, "    float sink = 0.f;\n" + loop)
                .replace(after, "    cp_async_wait<0>();\n    if (sink == 1234.5f) wh[0] = 1u;"
                                "\n    __syncthreads();\n"))
    loads_ticket = no_count.replace(finish, "return;")
    return {"whole": src, "no_finish": src.replace(finish, "return;"),
            "loads_ticket": loads_ticket,
            "loads": loads_ticket.replace("if (sink == 1234.5f) wh[0] = 1u;\n    __syncthreads();\n",
                                          "if (sink == 1234.5f) wh[0] = 1u;\n    __syncthreads();\n"
                                          + stop),
            "setup": src.replace(setup, setup + stop), "launch": src.replace(entry, entry + stop)}


def variants() -> dict:
    """{case: {variant: ms from CUDA graphs}} of this checkout's kernel whole
    and cut down (each built from a copy of the source)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from sod_tpu_torch.ops import _build, fsweep

    with open(os.path.join(_build.CSRC_DIR, "fsweep.cu")) as f:
        sources = _variant_sources(f.read())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    inv = float(np.float32(1.0 / 255))
    out = {case: {} for case in ("full16", "full4")}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR if os.path.isdir(_build.BUILD_DIR)
                                     else None) as tmp:
        procs = {}
        for name, src in sources.items():
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(src)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        fns = {}
        for name, proc in procs.items():
            log = proc.communicate(timeout=600)[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
            fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).sod_fmax_tp_cnt
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            fns[name] = fn
        for case in out:
            masks, gt, rowv, colv = _inputs(case)
            b, m, h, w = masks.shape
            rows = fsweep.band_rows(b, h, w, n_sm)
            for name, fn in fns.items():
                part = torch.empty(b * -(-h // rows) * 2 * m * 256, dtype=torch.int32,
                                   device="cuda")
                counters = torch.zeros(b, dtype=torch.int32, device="cuda")
                res = torch.empty(2, b, m, 255, device="cuda")

                def call(fn=fn, part=part, counters=counters, res=res, name=name):
                    rc = fn(*(t.data_ptr() for t in (masks, gt, rowv, colv)), inv,
                            part.data_ptr(), counters.data_ptr(), res[0].data_ptr(),
                            res[1].data_ptr(), b, m, h, w, 255, rows, 1,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")

                out[case][name] = _graph_ms(call)
    return out


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps({"tree": os.getcwd(), **measure()}), flush=True)
        return
    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds, args = int(args[i + 1]), args[:i] + args[i + 2:]
    if not args:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = []
    for r in range(rounds):
        order += args if r % 2 == 0 else args[::-1]
    for d in order:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"],
                       cwd=d, check=True, timeout=900)
    print(json.dumps({"variants_ms": variants()}), flush=True)


if __name__ == "__main__":
    main()
