"""Readings that a cell's correctness limits are set from (not run by the
benchmark's own runs).  For each seed, in one process: the cell's set-up,
a short window at the cell's own load where its traffic needs one, then
the program's compared numbers, the control's (the reference in fp8 in the
program's place) and each fault's, one JSON line per seed.

    python3 -m sodbench.calibrate --workload <name> --seeds 11,12,13 [--seconds 3]
"""
import argparse
import json
import sys
import time
from types import SimpleNamespace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from sodbench import harness

    harness.set_cache_dirs()
    import torch

    from sodbench.trace import Spans

    man = harness.manifest()
    cell = harness.by_name(man["workloads"], args.workload, "workload")
    harness.require_cards(cell["chips"])
    traffic = harness.traffic_file(cell["traffic"])
    config = harness.config_file(man, cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = SimpleNamespace(seed=seed, device=torch.device("cuda"), cell=cell,
                              workload=args.workload, config=config, traffic=traffic,
                              spans=Spans(False))
        driver = harness.driver_module(traffic).Driver(ctx)
        driver.setup(harness.SetupClock(t))
        if traffic["driver"] != "train":
            driver.run_window(args.seconds)
        driver.release()
        out = driver.calibrate()
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
