"""Tracing / profiling utilities of the port (twin of
``sod_tpu/utils/profiling.py``): ``StepTimer`` as there; ``span``, the
program's own spans, and ``trace`` on ``torch.profiler`` instead of
``jax.profiler``.

``span(name, **counts)`` marks a phase where the work happens (the train
step's ``step``, ``forward``, ``criterion``, ``backward``, ``optimizer`` and
``grad_sync``, ``train/step.py``).  Recording is off unless a
``torch.profiler`` session runs or the caller is inside ``recording()``;
off, ``span`` checks two flags and returns one shared no-op context.  On,
each span keeps in memory its name, its parent (a stack per thread), the
step it belongs to (the identifier of its outermost span), its host
interval on ``time.perf_counter_ns`` with the wall-clock offset that maps
it onto the clock ``torch.profiler`` stamps its events with, its counts
and, once CUDA is initialised, a pair of CUDA events recorded on the
current stream at enter and at exit.  It also enters
``record_function(name)``, so a profiler trace shows the span.  The
device milliseconds are read from the events only when asked for
(``SpanRecord.device_ms``), after the work: never inside a step.
``records()`` returns what was recorded; ``trace()`` writes it out.

Inside ``cut_at_spans(fn)`` the thread's spans record nothing: each calls
``fn`` as it opens and as it closes, where the train step's CUDA-graph
capture ends one graph and begins the next (``train/step.py``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class SpanRecord:
    """One span: ``t0_ns`` / ``t1_ns`` on the perf counter (``t1_ns`` is
    None while it is open), ``offset_ns`` the wall clock minus the perf
    counter at its start; ``parent`` the id of the enclosing span, ``step``
    the id of the outermost one."""

    __slots__ = ("id", "name", "parent", "step", "counts", "t0_ns", "t1_ns", "offset_ns",
                 "_start", "_end", "_ms")

    def __init__(self, id_: int, name: str, parent: Optional[int], step: int,
                 counts: Dict[str, int]):
        self.id, self.name, self.parent, self.step, self.counts = id_, name, parent, step, counts
        self.t0_ns = self.t1_ns = None
        self.offset_ns = 0
        self._start = self._end = self._ms = None

    def wall_ns(self):
        """(start, end) on the wall clock, ``torch.profiler``'s clock."""
        return self.t0_ns + self.offset_ns, self.t1_ns + self.offset_ns

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's two CUDA events; waits for
        the end event.  None without events or while the span is open."""
        if self._ms is None and self._end is not None:
            self._end.synchronize()
            self._ms = self._start.elapsed_time(self._end)
        return self._ms

    def as_dict(self) -> dict:
        t0, t1 = self.wall_ns()
        return {"id": self.id, "name": self.name, "parent": self.parent, "step": self.step,
                "start_ns": t0, "end_ns": t1, "device_ms": self.device_ms(),
                "counts": self.counts}


class _Off:
    """The shared context ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording = 0
_lock = threading.Lock()
_records: List[SpanRecord] = []
_ids = itertools.count()
_local = threading.local()
_cut = None                  # (thread id, fn) inside cut_at_spans


def span(name: str, **counts):
    """A context marking one phase of the program, recorded while a torch
    profiler session runs or inside ``recording()``; ``counts`` are kept
    with it (``rows=64``)."""
    if _cut is not None and _cut[0] == threading.get_ident():
        return _Cut(name, counts, _cut[1])
    if not (_autograd_profiler._is_profiler_enabled or _recording):
        return _OFF
    return _Span(name, counts)


class _Cut:
    """The context ``span`` returns inside ``cut_at_spans``."""

    __slots__ = ("name", "counts", "fn")

    def __init__(self, name: str, counts: Dict[str, int], fn):
        self.name, self.counts, self.fn = name, counts, fn

    def __enter__(self):
        self.fn(self.name, self.counts)
        return None

    def __exit__(self, *exc):
        self.fn(None, None)
        return False


@contextlib.contextmanager
def cut_at_spans(fn) -> Iterator[None]:
    """On this thread, inside this block, every span records nothing and
    calls ``fn(name, counts)`` as it opens and ``fn(None, None)`` as it
    closes."""
    global _cut
    if _cut is not None:
        raise RuntimeError("cut_at_spans does not nest")
    _cut = (threading.get_ident(), fn)
    try:
        yield
    finally:
        _cut = None


class _Span:
    __slots__ = ("name", "counts", "rec", "fn")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> SpanRecord:
        t0 = time.perf_counter_ns()
        offset = time.time_ns() - time.perf_counter_ns()
        stack = _stack()
        parent = stack[-1] if stack else None
        i = next(_ids)
        rec = SpanRecord(i, self.name, None if parent is None else parent.id,
                         i if parent is None else parent.step, self.counts)
        rec.t0_ns, rec.offset_ns = t0, offset
        self.fn = _autograd_profiler.record_function(self.name)
        self.fn.__enter__()
        if torch.cuda.is_initialized():
            rec._start = torch.cuda.Event(enable_timing=True)
            rec._start.record()
        stack.append(rec)
        _records.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec._end = end
        self.fn.__exit__(*exc)
        _stack().pop()
        rec.t1_ns = time.perf_counter_ns()
        return False


def _stack() -> List[SpanRecord]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block, with or without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def records() -> List[SpanRecord]:
    """Every closed span recorded since the last ``reset()``, in the order
    they opened."""
    return [r for r in list(_records) if r.t1_ns is not None]


def reset() -> None:
    """Forget every recorded span."""
    del _records[:]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, with a card, device
    activity) as ``<log_dir>/trace.json``, viewable in Perfetto, and the
    program's spans recorded meanwhile as ``<log_dir>/spans.json``: each
    with its host interval on the profiler's clock (wall-clock ns; a
    ``trace.json`` event is at ``ts * 1000 + baseTimeNanoseconds``), its
    device ms, its parent, its step and its counts.

    >>> with trace("/tmp/sod-trace"):
    ...     trainer(n_epochs=1)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof, recording():
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "wall-clock ns", "spans": [r.as_dict() for r in records()]}, f)


class StepTimer:
    """Rolling per-step wall-clock stats for the train loop (dispatch-based:
    pair with a periodic device sync for exact numbers)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def images_per_second(self, batch_size: int) -> float:
        s = self.mean_step_seconds
        return batch_size / s if s > 0 else 0.0
