"""The device timeline of a traced run (``--trace 1``), from
``torch.profiler`` over CUDA activity, and what the per-layer readers take
from it: the device's busy seconds inside the window, each operation's
time by name, and the idle gaps by the host span they fall in.

Kineto stamps events on the wall clock (``time.time_ns``); the harness
records its host spans on ``time.perf_counter_ns`` and maps them with the
offset taken at the window's start.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def clock_offset_ns() -> int:
    """wall-clock ns minus perf-counter ns, now."""
    return time.time_ns() - time.perf_counter_ns()


class Tracer:
    """Profiles the card while on; ``TraceSummary`` cuts its events to a window."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def device_events(self) -> List[Tuple[str, int, int]]:
        """(name, start ns, end ns) of every operation that ran on the card."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                t0, t1 = e.start_ns(), e.end_ns()
            else:
                t0, t1 = e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000
            out.append((e.name(), int(t0), int(t1)))
        return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, 64 characters at most."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)", "anon"))
    return re.sub(r"\s+", "_", name)[:64]


class TraceSummary:
    """The device timeline inside the window [t0, t1] (wall-clock ns)."""

    def __init__(self, events: List[Tuple[str, int, int]], t0: int, t1: int,
                 spans: Optional[List[Tuple[str, int, int]]] = None):
        self.t0, self.t1 = t0, t1
        self.ops = [(n, max(a, t0), min(b, t1)) for n, a, b in events if b > t0 and a < t1]
        self.n_events_total = len(events)
        self.window_s = (t1 - t0) / 1e9
        self.busy_intervals = _union([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e9
        self.spans = spans or []

    def count(self, patterns: List[str]) -> int:
        rx = [re.compile(p) for p in patterns]
        return sum(1 for n, _, _ in self.ops if any(r.search(n) for r in rx))

    def seconds(self, patterns: List[str]) -> float:
        rx = [re.compile(p) for p in patterns]
        return sum(b - a for n, a, b in self.ops if any(r.search(n) for r in rx)) / 1e9

    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.ops if not n.startswith(("Memcpy", "Memset")))

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, a, b in self.ops:
            by[short_name(n)] += (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, short_ns: int = 10_000) -> List[list]:
        """Idle device time summed by the latest-opened host span still open
        at each gap's midpoint (``outside_any_span`` where none is); gaps
        shorter than ``short_ns`` are summed apart, as launch gaps."""
        by: Dict[str, float] = defaultdict(float)
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        edges = [self.t0] + [x for ab in self.busy_intervals for x in ab] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < short_ns:
                by["gaps_under_10us"] += (b - a) / 1e9
                continue
            mid = (a + b) // 2
            name = "outside_any_span"
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - 64, -1), -1):     # spans overlap little
                if spans[i][2] > mid:
                    name = spans[i][0]
                    break
            by[name] += (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Spans:
    """Host spans the harness records around its calls into the program,
    on the perf counter, kept in memory while tracing is on."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[str, int, int]] = []

    def span(self, name: str):
        return _Span(self, name)

    def wall(self, offset_ns: int) -> List[Tuple[str, int, int]]:
        return [(n, a + offset_ns, b + offset_ns) for n, a, b in self.items]


class _Span:
    __slots__ = ("owner", "name", "t0")

    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        if self.owner.on:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.owner.on:
            self.owner.items.append((self.name, self.t0, time.perf_counter_ns()))
        return False
