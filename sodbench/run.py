"""Run one cell of the benchmark once.

    python3 -m sodbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, CUDA, the program's kernel
libraries, weights and inputs made on the card from the seed, the cell's
shapes warmed up) is timed from the process's start; then the window runs
for ``--seconds``; then the program's outputs are held against the plain
reference in ``sodbench/reference/``.  The last line of stdout is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and ``breakdown`` when traced), then ``checks``, each compared number
beside its limit.  Exits non-zero, printing no result, without the cards
the cell asks for or if JAX or the JAX package got loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_jax() -> bool:
    """Whether JAX or the JAX package is in ``sys.modules``; names them."""
    from sodbench import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"sodbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sodbench import harness

    harness.set_cache_dirs()
    man = harness.manifest()
    cell = harness.by_name(man["workloads"], args.workload, "workload")
    clock = harness.SetupClock(T0)
    with clock.phase("imports"):
        import torch

        from sodbench.trace import Spans, TraceSummary, Tracer, clock_offset_ns
    try:
        harness.require_cards(cell["chips"])
    except harness.NoCard as e:
        print(f"sodbench: {e}", file=sys.stderr)
        return 3
    with clock.phase("cuda_init"):
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    traffic = harness.traffic_file(cell["traffic"])
    ctx = SimpleNamespace(seed=args.seed, device=torch.device("cuda"), cell=cell,
                          workload=args.workload, config=harness.config_file(man, cell["config"]),
                          traffic=traffic, spans=Spans(bool(args.trace)))
    driver = harness.driver_module(traffic).Driver(ctx)
    driver.setup(clock)
    setup_s = clock.total(time.perf_counter())
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in clock.phases.items())
          + f" total {setup_s:.3f}", file=sys.stderr)

    tracer = Tracer() if args.trace else None
    if tracer:
        tracer.start()
    offset = clock_offset_ns()
    window = driver.run_window(args.seconds)
    if tracer:
        tracer.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if loaded_jax():
        return 4

    run = SimpleNamespace(cell=cell, traffic=traffic, counters=driver.counters(),
                          setup_s=setup_s, trace=None)
    if tracer:
        run.trace = TraceSummary(tracer.device_events(), window["t0_ns"] + offset,
                                 window["t1_ns"] + offset, ctx.spans.wall(offset))
    attempted, failed = driver.attempted_failed()
    metrics = {}
    for m in harness.cell_metrics(man, args.workload, bool(args.trace)):
        value = harness.metric_reader(m["name"]).read(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if tracer:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
        print(f"trace events {run.trace.n_events_total} in window {len(run.trace.ops)}",
              file=sys.stderr)

    driver.release()
    readings = driver.readings()
    print("readings " + json.dumps(readings), file=sys.stderr)
    ok, checks = harness.judge(readings, harness.limits_file(args.workload))
    result["correct"] = bool(ok and failed == 0 and attempted > 0)
    if loaded_jax():
        return 4
    harness.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
