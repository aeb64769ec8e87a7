"""enc_ms.<cell kind>: device ms between the CUDA events of the program's
``encoder`` spans (the encoder's call inside MaskFormer's forward,
sod_tpu_torch/models/maskformer.py) in the traced window, per step
(sodbench/program_spans.py); nothing where the program records no such
span."""
from sodbench import program_spans


def read(name, run):
    return program_spans.phase_ms(run, "encoder")
