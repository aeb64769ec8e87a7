"""launches.<cell kind>: kernels the card ran in the traced window per
training step."""


def read(name, run):
    t, c = run.trace, run.counters
    if t is None or not c.get("steps"):
        return None
    n = t.n_kernels()
    return n / c["steps"] if n else None
