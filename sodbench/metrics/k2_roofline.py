"""k2_roofline.<cell kind>: K2's bound at the launches' shapes over K2's
device time in the traced window, in %.  The bound of a launch is the
larger of its operations over the bf16 peak and its bytes over HBM's
bandwidth (sodbench/flops.py); kernels are matched by name
(sodbench/kernels.json)."""
import json
import os

_KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "kernels.json")


def read(name, run):
    t, c = run.trace, run.counters
    if t is None or "k2_fwd_bound_s" not in c:
        return None
    with open(_KERNELS) as f:
        k = json.load(f)
    n_fwd = t.count(k["k2_fwd"])
    n_bwd = t.count(k["k2_bwd"][:1])
    seconds = t.seconds(k["k2_fwd"] + k["k2_bwd"])
    if n_fwd == 0 or seconds <= 0:
        return None
    bound = n_fwd * c["k2_fwd_bound_s"] + n_bwd * c.get("k2_bwd_bound_s", 0.0)
    return 100.0 * bound / seconds
