"""``graphed.train`` (``sodbench/metrics/graphed.py``) on spans recorded on
the CPU: the share of the window's ``step`` spans whose ``graphed`` count
is 1, and nothing where the spans are not one per step or carry no such
count.  Run with

    python -m pytest sodbench/tests/test_bench_graphed.py -q
"""
from types import SimpleNamespace

import pytest

from sodbench import harness
from sodbench.trace import TraceSummary
from sod_tpu_torch.utils import profiling

NAME = "graphed.train"


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _run(flags, steps=None):
    """A step span per entry of ``flags`` (its ``graphed`` count, or none for
    None), each with a ``forward`` child, and a run that counted ``steps``."""
    with profiling.recording():
        for g in flags:
            counts = {"rows": 4, "micro": 1} if g is None else {"rows": 4, "micro": 1,
                                                                "graphed": g}
            with profiling.span("step", **counts):
                with profiling.span("forward"):
                    pass
    recs = profiling.records()
    t0 = min(r.wall_ns()[0] for r in recs) - 1000
    t1 = max(r.wall_ns()[1] for r in recs) + 1000
    return SimpleNamespace(counters={"kind": "train", "steps": len(flags) if steps is None
                                     else steps},
                           trace=TraceSummary([("kernel", t0, t1)], t0, t1))


def _read(run):
    return harness.metric_reader(NAME).read(NAME, run)


def test_the_manifest_lists_it_for_both_train_cells():
    (m,) = [m for m in harness.manifest()["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["moves"]) == ("%", "higher", "train_img_per_s")
    assert sorted(m["workloads"]) == ["vitg14reg-train-b8", "vits8-train-b64"]


@pytest.mark.parametrize("flags,want", [([1, 1, 1, 1], 100.0), ([0, 1, 1, 0], 50.0),
                                        ([0, 0], 0.0)])
def test_share_of_graphed_steps(flags, want):
    assert _read(_run(flags)) == want


def test_nothing_without_one_step_span_a_step():
    assert _read(_run([1, 1, 1], steps=2)) is None
    run = _run([1, 1])
    run.trace = None
    assert _read(run) is None


def test_nothing_where_the_steps_carry_no_count():
    assert _read(_run([None, None])) is None
    assert _read(_run([1, None])) is None
