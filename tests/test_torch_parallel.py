"""The port's data-parallel helpers (``sod_tpu_torch/parallel``) against
``sod_tpu/parallel`` as pure functions, in this process.

* ``fsdp_specs`` / ``zero1_moment_shardings`` pick, for every leaf of the
  live model's tree (ViT-S/8, 20 queries, 6 decoder layers) and of the
  ResNet-50 MaskFormer, the same leaves and the same semantic axis as
  ``sod_tpu``'s at data sizes 2, 4 and 8: each ``sod_tpu`` leaf is filled
  with the rank that owns each element under its spec, carried through
  ``state_dict_from_jax``, and every port parameter must then hold rank r's
  values exactly in its own shard r (whole leaves: no owner).
* ``assert_fsdp_compatible`` and ``assert_xla_path`` raise ``sod_tpu``'s
  errors, word for word.
* ``batch_sharding`` gives rank r the rows that ``P("data")`` puts on device
  r, and under accumulation the rank's block of each micro-batch.
* A 1-rank mesh in this process (gloo): its step, every collective called,
  equals the step with no mesh bit for bit.
* ``make_mesh`` beyond the devices and the Trainer's ``fsdp`` with no mesh
  raise ``sod_tpu``'s ``ValueError``s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sod_tpu.config import Config as JaxConfig
from sod_tpu.models.maskformer import config_from as jax_config_from
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.parallel import fsdp as jax_fsdp
from sod_tpu.parallel import mesh as jax_mesh_mod
from sod_tpu.parallel import batch_sharding as jax_batch_sharding
from sod_tpu.parallel import make_mesh as jax_make_mesh
from sod_tpu_torch.config import Config
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, config_from
from sod_tpu_torch.models.maskformer import random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.parallel import (assert_fsdp_compatible, batch_sharding, fsdp_param_shardings,
                                    fsdp_specs, make_mesh, shard_batch, zero1_moment_shardings)
from sod_tpu_torch.parallel import fsdp as port_fsdp
from sod_tpu_torch.parallel import mesh as port_mesh
from sod_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, StateLayout


class _Mesh:
    """The ``data`` axis of a DeviceMesh of ``n`` ranks, for the pure rules."""
    mesh_dim_names = ("data",)

    def __init__(self, n):
        self.n = n

    def size(self, dim=0):
        return self.n


def _owner_probe(shapes, specs, n):
    """Each sod_tpu leaf filled with the rank owning each element under its
    spec (-1 everywhere for a whole leaf)."""
    def fill(leaf, spec):
        shape = leaf.shape
        axes = [i for i, e in enumerate(tuple(spec)) if e == "data"]
        if not axes:
            return np.full(shape, -1.0, np.float32)
        d = axes[0]
        owner = np.arange(shape[d]) // (shape[d] // n)
        view = [1] * len(shape)
        view[d] = shape[d]
        return np.broadcast_to(owner.reshape(view), shape).astype(np.float32)
    return jax.tree.map(fill, shapes, specs, is_leaf=lambda x: isinstance(x, P))


def _check_same_leaves_and_axes(jax_cfg, port_model, n, moments=False):
    shapes = jax.eval_shape(lambda: maskformer_init(jax.random.key(0),
                                                    jax_config_from(jax_cfg)))
    mesh = jax_make_mesh(n)
    if moments:
        rep = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=jax.sharding.NamedSharding(mesh, P())), shapes)
        specs = jax.tree.map(lambda sh: sh.spec, jax_fsdp.zero1_moment_shardings(rep, mesh))
        ours = zero1_moment_shardings(port_model, _Mesh(n))
    else:
        specs = jax_fsdp.fsdp_specs(shapes, mesh)
        ours = fsdp_specs(port_model, _Mesh(n))
    probe = state_dict_from_jax(_owner_probe(shapes, specs, n))
    n_sharded = 0
    for name, p in port_model.named_parameters():
        got = probe[name]
        d = ours[name]
        if d is None:
            assert (got == -1).all(), name
            continue
        n_sharded += 1
        c = p.shape[d] // n
        for r in range(n):
            assert (np.take(got, range(r * c, (r + 1) * c), axis=d) == r).all(), (name, r)
    return n_sharded


@pytest.fixture(scope="module")
def live_model():
    return MaskFormer(config_from(Config()))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("moments", [False, True], ids=["fsdp_specs", "zero1_moments"])
def test_specs_pick_sod_tpus_leaves_and_axes_on_the_live_model(live_model, n, moments):
    n_sharded = _check_same_leaves_and_axes(JaxConfig(), live_model, n, moments)
    # every encoder block's four linears, every decoder layer's six
    # projections, the pos-embed, the patch embedding, the FFN
    assert n_sharded > 12 * 4 + 6 * 6


def test_specs_pick_sod_tpus_leaves_and_axes_on_the_resnet50():
    model = MaskFormer(config_from(Config(arch="resnet50")))
    assert _check_same_leaves_and_axes(JaxConfig(arch="resnet50"), model, 4) > 50


def test_spec_rule_on_single_leaves():
    """``sod_tpu``'s rule in the port's layout: the largest divisible axis of
    ``sod_tpu``'s leaf, the lowest one among equals; small leaves whole."""
    model = MaskFormer(MaskFormerConfig(n_queries=4, n_decoder_layers=2,
                                        vit=ViTConfig(embed_dim=384, depth=2, n_heads=6)))
    specs = fsdp_specs(model, _Mesh(8))
    assert specs["encoder.blocks.0.attn.qkv.weight"] == 0        # (in 384, out 1152) -> out
    assert specs["encoder.blocks.0.attn.proj.weight"] == 1       # (384, 384) tie -> in
    assert specs["encoder.blocks.0.mlp.fc2.weight"] == 1         # (in 1536, out 384) -> in
    assert specs["encoder.pos_embed"] == 2                       # 785 % 8 != 0 -> D
    assert specs["encoder.blocks.0.norm1.weight"] is None        # < MIN_SHARD_SIZE
    assert fsdp_param_shardings(model, _Mesh(8)) == specs
    assert all(d is None for d in fsdp_specs(model, _Mesh(1)).values())
    assert port_fsdp.MIN_SHARD_SIZE == jax_fsdp.MIN_SHARD_SIZE == MIN_SHARD_SIZE


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("cfg_kw,n", [
    ({"fsdp": "zero1"}, None), ({"fsdp": "zero1"}, 1), ({"fsdp": "zero1"}, 8),
    ({"fsdp": "full", "use_fused_train": True}, 8), ({"fsdp": "zero1", "use_fused_train": True}, 8),
    ({"fsdp": "zero3"}, 8), ({"fsdp": "full", "use_pallas_attention": False}, 8)])
def test_assert_fsdp_compatible_raises_sod_tpus_errors(cfg_kw, n):
    jax_mesh = None if n is None else jax_make_mesh(n)
    ours = None if n is None else _Mesh(n)
    want = _err(lambda: jax_fsdp.assert_fsdp_compatible(JaxConfig(**cfg_kw), jax_mesh))
    got = _err(lambda: assert_fsdp_compatible(Config(**cfg_kw), ours))
    assert got == want


def test_kernel_flags_and_xla_path_guard_are_sod_tpus():
    assert port_mesh.PALLAS_FLAGS == jax_mesh_mod.PALLAS_FLAGS
    cfg_kw = {"use_fused_mlp": True, "use_fused_eval": True}
    want = _err(lambda: jax_mesh_mod.assert_xla_path(JaxConfig(**cfg_kw), "x", "y"))
    assert _err(lambda: port_mesh.assert_xla_path(Config(**cfg_kw), "x", "y")) == want


@pytest.mark.parametrize("n", [2, 4])
def test_batch_rows_are_the_rows_p_data_puts_on_each_device(n):
    x = np.arange(16)
    placed = jax.device_put(jnp.asarray(x), jax_batch_sharding(jax_make_mesh(n)))
    by_device = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    devices = [d.id for d in jax_make_mesh(n).devices.flat]
    for r in range(n):
        assert list(batch_sharding(_Mesh(n), 16, rank=r)) == list(by_device[devices[r]])
    # two micro-batches (rows [0, 8) and [8, 16)): rank r's block of each
    for r in range(n):
        rows = batch_sharding(_Mesh(n), 16, accum_steps=2, rank=r)
        c = 8 // n
        assert list(rows) == list(range(r * c, (r + 1) * c)) + list(range(8 + r * c, 8 + (r + 1) * c))
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(_Mesh(n), 6, accum_steps=2)


def test_a_one_rank_mesh_step_equals_the_step_without_a_mesh():
    """Every collective of the mesh path runs at a world size of 1 (gloo
    here, NCCL on the card): the step is the no-mesh step bit for bit."""
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import make_train_step

    cfg = Config(batch_size=4, compute_dtype="float32", use_pallas_attention=False,
                 max_gt_masks=2)
    mcfg = MaskFormerConfig(n_queries=4, n_decoder_layers=2,
                            vit=ViTConfig(embed_dim=32, depth=2, n_heads=2, pos_grid=4))
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32)),
             "gt_masks": torch.from_numpy((rng.rand(4, 2, 32, 32) > 0.5).astype(np.float32)),
             "gt_valid": torch.ones(4, 2, dtype=torch.bool),
             "labels": torch.tensor([0, 1, 0, 1])}
    sd = random_state_dict(MaskFormer(mcfg), 0)
    out = {}
    mesh = make_mesh(1, "cpu")
    try:
        assert mesh.mesh_dim_names == ("data",) and port_mesh.data_size(mesh) == 1
        for name, m in (("none", None), ("mesh", mesh)):
            model = MaskFormer(mcfg)
            model.load_state_dict(sd)
            layout = None if m is None else StateLayout(model, m, "zero1")
            opt = build_optimizer(cfg, model.parameters() if m is None else layout.tensors,
                                  n_iters_per_epoch=10)
            step = make_train_step(cfg, model, opt, layout=layout)
            metrics = [step(shard_batch(batch, m) if m is not None else batch)
                       for _ in range(2)][-1]
            out[name] = (metrics, model.state_dict(), opt.mu)
    finally:
        torch.distributed.destroy_process_group()
    for k, v in out["none"][0].items():
        assert torch.equal(v, out["mesh"][0][k]), k
    for k, v in out["none"][1].items():
        assert torch.equal(v, out["mesh"][1][k]), k
    assert all(torch.equal(a, b) for a, b in zip(out["none"][2], out["mesh"][2]))


def test_make_mesh_refuses_more_ranks_than_devices_before_any_rendezvous():
    with pytest.raises(ValueError, match="requested 999 devices"):
        make_mesh(999, "cpu")
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2, "cuda")          # no card here
    with pytest.raises(ValueError, match="spawn_ranks"):
        make_mesh(2, "cpu")           # no group of two to join
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("level", ["zero1", "full"])
def test_trainer_with_fsdp_and_no_mesh_raises_sod_tpus_error(tmp_path, level):
    """``fsdp`` with no mesh fails loudly before anything is built, as
    ``sod_tpu``'s Trainer does (``tests/test_fsdp.py``)."""
    from sod_tpu_torch.train.trainer import Trainer

    cfg = Config(dir_dataset=str(tmp_path), dir_ckpt=str(tmp_path / "ckpt"), fsdp=level,
                 use_pallas_attention=False)
    with pytest.raises(ValueError, match="needs a data mesh axis > 1"):
        Trainer(cfg, device="cpu")
