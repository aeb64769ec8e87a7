"""On the card, at each cell's own size: the program's run comes out
correct under the cell's limits; the control (the reference in fp8 in the
program's place) and every fault the cell can have come out not correct.
Skips without a card; run on the H100 with

    python -m pytest sodbench/tests/test_bench_card.py -q
"""
import time
from types import SimpleNamespace

import pytest

from sodbench import harness
from sodbench.trace import Spans

MAN = harness.manifest()


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_and_faults_fail_the_limits(cell, card):
    w = harness.by_name(MAN["workloads"], cell, "workload")
    traffic = harness.traffic_file(w["traffic"])
    ctx = SimpleNamespace(seed=2 ** 33 + 19, device=card, cell=w, workload=cell,
                          config=harness.config_file(MAN, w["config"]), traffic=traffic,
                          spans=Spans(False))
    driver = harness.driver_module(traffic).Driver(ctx)
    driver.setup(harness.SetupClock(time.perf_counter()))
    if traffic["driver"] != "train":
        driver.run_window(3.0)
    driver.release()
    limits = harness.limits_file(cell)
    readings = driver.calibrate()
    assert harness.judge(readings.pop("program"), limits)[0]
    for kind, numbers in readings.items():
        assert not harness.judge(numbers, limits)[0], kind
