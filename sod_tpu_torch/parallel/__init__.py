"""The port's parallel layouts (twin of ``sod_tpu/parallel``): the ``data``
mesh over processes (``mesh.py``), ZeRO-1 / FSDP-full state sharding
(``fsdp.py``), and the model-sharding layouts over the collectives of
``comm.py``: Megatron TP (``tp.py``), GPipe PP (``pp.py``), ring-attention
SP (``sp.py``) and their 3-D compositions (``p3.py``, ``sptp.py``)."""
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
from sod_tpu_torch.parallel.p3 import (  # noqa: F401
    assert_p3_compatible,
    make_mesh_3d,
    make_p3_apply,
    p3_host_params,
    p3_merge_blocks,
    p3_param_shardings,
    p3_split_blocks,
    p3_vit_apply,
    shard_params_p3,
)
from sod_tpu_torch.parallel.pp import (  # noqa: F401
    assert_pp_compatible,
    make_mesh_pp,
    make_pp_apply,
    pp_param_shardings,
    pp_specs,
    pp_vit_apply,
    shard_params_pp,
)
from sod_tpu_torch.parallel.sptp import (  # noqa: F401
    assert_sptp_compatible,
    make_mesh_sptp,
    make_sptp_apply,
    shard_params_sptp,
    sptp_block_specs,
    sptp_param_shardings,
    sptp_vit_apply,
)
from sod_tpu_torch.parallel.sp import (  # noqa: F401
    assert_sp_compatible,
    make_mesh_sp,
    make_sp_apply,
    ring_attention,
    sp_vit_apply,
)
from sod_tpu_torch.parallel.tp import (  # noqa: F401
    assert_tp_compatible,
    make_mesh_2d,
    opt_state_shardings,
    param_shardings,
    shard_opt_state,
    shard_params,
    tp_specs,
)
