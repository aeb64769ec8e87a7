"""gemm_roofline.<cell kind>: the least time of the step's linear products
on the tensor cores (sodbench/flops_dinov2.py: each product's operations
over the bf16 peak or its bytes over HBM's bandwidth, the larger, summed;
per step) times the steps, over the device time of the ``gemm_kernel``
launches in the traced window, in %.  Kernels are matched by name here."""

GEMM_KERNEL = [r"\bgemm_kernel\b"]


def read(name, run):
    t, c = run.trace, run.counters
    if t is None or not c.get("gemm_bound_s_per_step") or not c.get("steps"):
        return None
    seconds = t.seconds(GEMM_KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * c["steps"] * c["gemm_bound_s_per_step"] / seconds
