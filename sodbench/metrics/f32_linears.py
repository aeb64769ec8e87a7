"""f32_linears.<cell kind>: the program's bf16 linears a step left on the f32
products (sod_tpu_torch/ops/layers.py counter ``f32_linears`` over the
window, per step, as sodbench/drivers/train_vitg.py counts it); nothing
where the cell counts none."""


def read(name, run):
    value = run.counters.get("f32_linears_per_step")
    return None if value is None else float(value)
