"""batch_rows.serve: requests completed in the window over the forwards the
service ran in it: how full the micro-batcher's batches were."""


def read(name, run):
    c = run.counters
    if c.get("kind") != "serve" or not c.get("forwards"):
        return None
    return c["requests"] / c["forwards"]
