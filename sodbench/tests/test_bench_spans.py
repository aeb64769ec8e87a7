"""The per-layer metrics that read the program's own spans
(``sodbench/program_spans.py``, ``sod_tpu_torch.utils.profiling``).

On the card: a span and the profiler's device events share one clock; on
a short traced run of ``vits8-train-b64`` the four phase metrics add up to
the step's time and ``stall_ms`` is at most the window's idle.  On the
CPU: the readers give nothing where the spans do not match the run's steps
or the program keeps no spans.  Run on the H100 with

    python -m pytest sodbench/tests/test_bench_spans.py -q
"""
import time
from types import SimpleNamespace

import pytest
import torch

from sodbench import harness
from sodbench.trace import Spans, TraceSummary, Tracer, clock_offset_ns
from sod_tpu_torch.utils import profiling

MAN = harness.manifest()
SPAN_METRICS = [m["name"] for m in MAN["per_layer"] if m["source"] == "program_span"]
PHASE_METRICS = ["fwd_ms.train", "loss_ms.train", "bwd_ms.train", "opt_ms.train"]
CELL = "vits8-train-b64"


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _read(run):
    return {name: harness.metric_reader(name).read(name, run) for name in SPAN_METRICS}


def _cpu_run(n_spans: int, steps: int):
    """``n_spans`` recorded steps of ~2 ms, each with a ``forward`` child, and
    a run that counted ``steps``; the device is busy over the first half of
    each step."""
    with profiling.recording():
        for _ in range(n_spans):
            with profiling.span("step", rows=4, micro=1):
                with profiling.span("forward"):
                    time.sleep(0.002)
    recs = profiling.records()
    busy = []
    for r in recs:
        if r.name == "step":
            a, b = r.wall_ns()
            busy.append(("kernel", a, (a + b) // 2))
    t0 = min(r.wall_ns()[0] for r in recs) - 1000
    t1 = max(r.wall_ns()[1] for r in recs) + 1000
    return SimpleNamespace(counters={"kind": "train", "steps": steps},
                           trace=TraceSummary(busy, t0, t1)), recs


def test_the_manifest_lists_the_span_metrics():
    assert sorted(SPAN_METRICS) == sorted(PHASE_METRICS + ["stall_ms.train"])


@pytest.mark.parametrize("metric", sorted(PHASE_METRICS + ["stall_ms.train"]))
def test_readers_give_nothing_when_steps_do_not_match(metric):
    run, _ = _cpu_run(n_spans=3, steps=2)
    assert harness.metric_reader(metric).read(metric, run) is None
    run.trace = None
    assert harness.metric_reader(metric).read(metric, run) is None


def test_readers_give_nothing_without_the_programs_records(monkeypatch):
    run, _ = _cpu_run(n_spans=2, steps=2)
    monkeypatch.delattr(profiling, "records")
    assert all(v is None for v in _read(run).values())


def test_stall_counts_gaps_inside_spans_only():
    """On the CPU there are no CUDA events (the phases read None).  Each idle
    gap runs from a step's midpoint to the next step's start (or the
    window's end), so its midpoint lies inside the step's span; the gap
    before the first step is 1 us, a launch gap."""
    run, recs = _cpu_run(n_spans=3, steps=3)
    got = _read(run)
    assert all(got[m] is None for m in PHASE_METRICS)
    steps = [r.wall_ns() for r in recs if r.name == "step"]
    ends = [a for a, _ in steps[1:]] + [run.trace.t1]
    want = sum(end - (a + b) // 2 for (a, b), end in zip(steps, ends)) / 1e6 / 3
    assert got["stall_ms.train"] == pytest.approx(want, rel=1e-9)
    assert got["stall_ms.train"] <= 1000 * (run.trace.window_s - run.trace.busy_s) / 3


# ------------------------------------------------------------ on the card

@pytest.mark.card
def test_span_and_device_events_share_a_clock(card):
    a = torch.randn(8192, 8192, device=card)
    b = torch.randn(8192, 8192, device=card)
    (a @ b).sum().item()
    tracer = Tracer()
    tracer.start()
    with profiling.span("gemm"):
        c = a @ b
        torch.cuda.synchronize()
    tracer.stop()
    (rec,) = [r for r in profiling.records() if r.name == "gemm"]
    t0, t1 = rec.wall_ns()
    name, s, e = max(tracer.device_events(), key=lambda ev: ev[2] - ev[1])
    assert e - s > 1_000_000, name                      # the GEMM, over 1 ms
    assert s >= t0 - 50_000 and e <= t1 + 50_000, (t0, s, e, t1)
    assert rec.device_ms() == pytest.approx((e - s) / 1e6, rel=0.1, abs=0.05)
    del c


@pytest.mark.card
def test_phase_metrics_add_up_to_the_step(card):
    w = harness.by_name(MAN["workloads"], CELL, "workload")
    traffic = harness.traffic_file(w["traffic"])
    ctx = SimpleNamespace(seed=2 ** 33 + 41, device=card, cell=w, workload=CELL,
                          config=harness.config_file(MAN, w["config"]), traffic=traffic,
                          spans=Spans(True))
    driver = harness.driver_module(traffic).Driver(ctx)
    driver.setup(harness.SetupClock(time.perf_counter()))
    tracer = Tracer()
    tracer.start()
    offset = clock_offset_ns()
    window = driver.run_window(3.0)
    tracer.stop()
    torch.cuda.synchronize()
    run = SimpleNamespace(cell=w, traffic=traffic, counters=driver.counters(), setup_s=0.0)
    run.trace = TraceSummary(tracer.device_events(), window["t0_ns"] + offset,
                             window["t1_ns"] + offset, ctx.spans.wall(offset))
    got = _read(run)
    driver.release()
    steps = run.counters["steps"]
    print({"steps": steps, "window_s": run.trace.window_s, "busy_s": run.trace.busy_s, **got})
    assert all(v is not None and v >= 0 for v in got.values()), got
    step_ms = 1000 * run.trace.window_s / steps
    phases = sum(got[m] for m in PHASE_METRICS)
    assert 0.90 * step_ms <= phases <= 1.01 * step_ms, (phases, step_ms)
    assert got["stall_ms.train"] <= 1000 * (run.trace.window_s - run.trace.busy_s) / steps
