"""idle.<cell kind>: the share of the traced window, in %, in which no
operation ran on the card (torch.profiler's device timeline)."""


def read(name, run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
