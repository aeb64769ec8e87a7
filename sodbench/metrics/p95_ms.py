"""p95_ms.serve: the 95th percentile, in ms, of the latency the callers saw,
over every request that completed in the window."""
import numpy as np


def read(name, run):
    lat = run.counters.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0) * 1e3)
