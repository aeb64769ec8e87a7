"""The port's parallel layouts (twin of ``sod_tpu/parallel``): the ``data``
mesh over processes (``mesh.py``) and ZeRO-1 / FSDP-full state sharding
(``fsdp.py``).  The model-sharding layouts (``tp``, ``pp``, ``sp``, ``p3``,
``sptp``) are ROADMAP item 12b."""
from sod_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from sod_tpu_torch.parallel.fsdp import (  # noqa: F401
    assert_fsdp_compatible,
    fsdp_param_shardings,
    fsdp_specs,
    shard_params_fsdp,
    zero1_moment_shardings,
)
