"""stall_ms.train: device idle in the traced window's gaps of 10 us or more
whose midpoint lies inside one of the program's spans
(sod_tpu_torch.utils.profiling), per step (sodbench/program_spans.py)."""
from sodbench import program_spans


def read(name, run):
    return program_spans.stall_ms(run)
