"""opt_ms.train: device ms between the CUDA events of the program's
``optimizer`` spans (sod_tpu_torch.utils.profiling) in the traced window, per
step (sodbench/program_spans.py)."""
from sodbench import program_spans


def read(name, run):
    return program_spans.phase_ms(run, "optimizer")
