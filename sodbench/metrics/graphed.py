"""graphed.<cell kind>: the share, in %, of the traced window's ``step``
spans (sod_tpu_torch.utils.profiling) that the program replayed from CUDA
graphs, by the span's ``graphed`` count (sodbench/program_spans.py).
Nothing where a step span carries no such count."""
from sodbench import program_spans


def read(name, run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    flags = [r.counts.get("graphed") for r in spans if r.name == "step"]
    if not flags or any(f is None for f in flags):
        return None
    return 100.0 * sum(1 for f in flags if f == 1) / len(flags)
