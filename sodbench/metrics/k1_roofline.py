"""k1_roofline.serve: K1's bound over the forwards of the window (twelve
launches each, at each forward's batch rows and real tokens) over K1's
device time in the traced window, in %; kernels matched by name
(sodbench/kernels.json)."""
import json
import os

_KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "kernels.json")


def read(name, run):
    t, c = run.trace, run.counters
    if t is None or not c.get("k1_bound_s"):
        return None
    with open(_KERNELS) as f:
        k = json.load(f)
    seconds = t.seconds(k["k1"])
    if seconds <= 0:
        return None
    return 100.0 * c["k1_bound_s"] / seconds
