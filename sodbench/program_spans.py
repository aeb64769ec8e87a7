"""The program's own spans of a traced run's window, for the readers of
``metrics/`` that read them: ``sod_tpu_torch.utils.profiling`` records a
span while a ``torch.profiler`` session runs, and the harness's starts
after set-up, so the spans recorded are the window's.

A reader gets None where the program keeps no such record, or where the
window's ``step`` spans are not one per step the run counted."""
from __future__ import annotations

import bisect
from typing import Optional

from sodbench.trace import _union

SHORT_NS = 10_000     # idle gaps shorter than this are launch gaps (trace.py)


def window_spans(run) -> Optional[list]:
    """The program's closed spans that start inside the traced window, or
    None."""
    t, steps = run.trace, run.counters.get("steps")
    if t is None or not steps:
        return None
    try:
        from sod_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    spans = [r for r in records() if t.t0 <= r.wall_ns()[0] <= t.t1]
    if sum(1 for r in spans if r.name == "step") != steps:
        return None
    return spans


def phase_ms(run, name: str) -> Optional[float]:
    """Device ms between the CUDA events of the window's ``name`` spans,
    per step."""
    spans = window_spans(run)
    if spans is None:
        return None
    ms = [r.device_ms() for r in spans if r.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / run.counters["steps"]


def stall_ms(run) -> Optional[float]:
    """Device idle, per step, in the window's gaps of ``SHORT_NS`` or more
    whose midpoint lies inside a program span (wall-clock ns)."""
    spans = window_spans(run)
    if spans is None:
        return None
    t = run.trace
    inside = _union([r.wall_ns() for r in spans])
    starts = [a for a, _ in inside]
    edges = [t.t0] + [x for ab in t.busy_intervals for x in ab] + [t.t1]
    idle = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < SHORT_NS:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and inside[i][1] > mid:
            idle += b - a
    return idle / 1e6 / run.counters["steps"]
