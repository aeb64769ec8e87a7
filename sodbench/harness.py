"""What every cell shares: the manifest and the files it names, the card
check, the build-cache directories, the set-up clock, the import check and
the result line.

Each part of a cell is found by its name: a configuration in
``configs/<config>.json``, a traffic mix in ``traffic/<traffic>.json``
(whose ``driver`` names the module of ``drivers/`` that runs it), a metric
in ``metrics/<metric>.py`` (or ``metrics/<prefix>.py`` for a name
``<prefix>.<suffix>``), and a cell's correctness limits in
``limits/<workload>.json``.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, ".sodbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "sod_tpu")


class NoCard(RuntimeError):
    """The cell asks for more cards than this process sees."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_file(man: dict, name: str) -> dict:
    entry = by_name(man["configs"], name, "configuration")
    return load_json(os.path.join(ROOT, entry["file"]))


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits_file(workload: str) -> dict:
    path = os.path.join(BENCH_DIR, "limits", f"{workload}.json")
    return load_json(path) if os.path.exists(path) else {}


def metric_reader(name: str):
    """The module that reads metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<prefix>.py`` for ``<prefix>.<suffix>``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(BENCH_DIR, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"sodbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise KeyError(f"no reader for metric {name!r} under sodbench/metrics/")


def reports(metric: dict, workload: str, man: dict) -> bool:
    """Whether cell ``workload`` reports ``metric``: it is listed, or the
    metric lists no cells and (for a per-layer metric) the cell reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        moved = by_name(man["end_to_end"], metric["moves"], "metric")
        return reports(moved, workload, man)
    return True


def cell_metrics(man: dict, workload: str, trace: bool) -> List[dict]:
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if reports(m, workload, man)]


def driver_module(traffic: dict):
    return importlib.import_module(f"sodbench.drivers.{traffic['driver']}")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory in the checkout.
    The program's own nvcc builds already sit in ``sod_tpu_torch/_build/``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def require_cards(chips: int):
    """Raise ``NoCard`` unless this process sees ``chips`` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card, no measurement")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


class SetupClock:
    """The set-up's split: ``with clock.phase(name)`` adds the seconds spent."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t

    def total(self, t_end: float) -> float:
        return t_end - self.t0


def judge(readings: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """The numbers the cell's limits file names, each beside its limit;
    correct when there is at least one and each is finite and at or under
    its limit."""
    checks, ok = {}, bool(limits.get("checks"))
    for name, entry in limits.get("checks", {}).items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": entry["limit"]}
        if value is None or not math.isfinite(value) or value > entry["limit"]:
            ok = False
    return ok, checks


def print_result(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers as the last lines of stderr, then the result as
    the last line of stdout with the checks under the last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
