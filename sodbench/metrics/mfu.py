"""mfu.<cell kind>: the model's operations for the work completed in the
window (the benchmark's own count, sodbench/flops.py, real tokens only)
over the window's seconds times the card's bf16 peak, in %."""
from sodbench import flops


def read(name, run):
    c = run.counters
    if not c.get("flops") or c["window_s"] <= 0:
        return None
    return 100.0 * c["flops"] / (c["window_s"] * flops.peaks()["bf16_flops_per_s"])
