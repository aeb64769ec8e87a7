"""The serve and evaluation drivers, whose cells are not in BENCHMARK.json
yet (PERF.md says why), run end to end at a size the CPU holds, and their
comparisons tell an answer handed to the wrong caller, and the wrong query
answered, from the program's own answers."""
import torch

from sodbench.tests.tiny import run_tiny


def test_serve_driver_runs_and_sees_swapped_answers():
    driver = run_tiny("selfmask-vits8-nq20", "serve_closed")
    counters = driver.counters()
    assert counters["requests"] > 0 and counters["forwards"] > 0
    assert 1.0 <= counters["requests"] / counters["forwards"] <= 32
    out = driver.calibrate()
    assert out["swapped"]["mask_gap"] > 3 * out["program"]["mask_gap"]
    assert out["swapped"]["obj_gap"] > 3 * out["program"]["obj_gap"]


def test_eval_driver_runs_and_reads_every_call():
    driver = run_tiny("selfmask-vits8-nq20", "eval_canvas")
    rows = driver.program_rows()
    assert len(rows) == len(driver.results) >= 1
    assert all(len(call) == 8 and all(len(r) == 14 for r in call) for call in rows)
    out = driver.calibrate()
    assert set(out) == {"program", "control", "wrong_pick"}
    assert torch.isfinite(torch.tensor(list(out["program"].values()))).all()
