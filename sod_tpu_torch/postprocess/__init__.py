from sod_tpu_torch.postprocess.bilateral_solver import (  # noqa: F401
    BilateralGrid,
    bilateral_solver_output,
)
