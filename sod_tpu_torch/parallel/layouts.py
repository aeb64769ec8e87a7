"""Which layout a mesh runs, for the Trainer, the Evaluator and the CLIs
(``sod_tpu/train/trainer.py:81-163``, ``sod_tpu/train/evaluator.py:108-131``).

A mesh's axis names say its layout: ``(data,)`` the data mesh, ``(data,
model)`` TP, ``(data, pipe)`` PP, ``(data, seq)`` SP, ``(data, pipe,
model)`` p3 and ``(data, seq, model)`` sptp, whatever the axes' sizes (so a
one-rank mesh of a layout runs that layout's code).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sod_tpu_torch.parallel.fsdp import StateLayout, assert_fsdp_compatible, mp_local_copy
from sod_tpu_torch.parallel.mesh import device_limit, make_mesh

_KINDS = {("data",): "data", ("data", "model"): "tp", ("data", "pipe"): "pp",
          ("data", "seq"): "sp", ("data", "pipe", "model"): "p3",
          ("data", "seq", "model"): "sptp"}


def mesh_kind(mesh) -> Optional[str]:
    """The layout of ``mesh`` (None without one)."""
    return None if mesh is None else _KINDS[tuple(mesh.mesh_dim_names)]


def mesh_from_config(cfg, device):
    """``sod_tpu``'s Trainer's mesh from ``mesh_{data,model,pipe,seq}_axis``:
    p3 when model and pipe are both above 1, sptp when model and seq are,
    else the one axis above 1 beside ``data``; the data mesh when only
    ``mesh_data_axis`` is above 1; None otherwise."""
    from sod_tpu_torch.parallel.p3 import make_mesh_3d
    from sod_tpu_torch.parallel.pp import make_mesh_pp
    from sod_tpu_torch.parallel.sp import make_mesh_sp
    from sod_tpu_torch.parallel.sptp import make_mesh_sptp
    from sod_tpu_torch.parallel.tp import make_mesh_2d

    tp, pp, sp = (getattr(cfg, f"mesh_{a}_axis", 1) for a in ("model", "pipe", "seq"))
    dp = cfg.mesh_data_axis if cfg.mesh_data_axis > 1 else None
    if tp > 1 and pp > 1:
        return make_mesh_3d(dp, pp, tp, device)
    if tp > 1 and sp > 1:
        return make_mesh_sptp(dp, sp, tp, device)
    if tp > 1:
        return make_mesh_2d(dp, tp, device)
    if pp > 1:
        return make_mesh_pp(dp, pp, device)
    if sp > 1:
        return make_mesh_sp(dp, sp, device)
    return make_mesh(cfg.mesh_data_axis, device) if cfg.mesh_data_axis > 1 else None


def cli_ranks(n_devices: Optional[int], device, tp: int = 1, pp: int = 1,
              sp: int = 1) -> Tuple[int, int]:
    """(data ranks, all ranks) of the CLIs' ``--n_devices/--tp/--pp/--sp``:
    ``n_devices`` data ranks (default every card left after the other axes,
    one on the CPU) times the other axes, with ``sod_tpu``'s ``ValueError``
    when the cards are too few, before any rendezvous."""
    if sp > 1 and pp > 1:
        raise SystemExit("--sp is mutually exclusive with --pp")
    kind = torch.device(device).type
    have = device_limit(kind)
    axes = [a for a in (pp, sp, tp) if a > 1]
    if not axes and n_devices is None:
        # the data mesh's default: every card (one on the CPU), no check
        n = have if kind == "cuda" else 1
        return n, n
    inner = 1
    for a in axes:
        inner *= a
    n_data = n_devices or (have // inner if kind == "cuda" else 1)
    total = n_data * inner
    if total > have or total < 1:
        raise ValueError(f"requested {'x'.join(str(a) for a in (n_data, *axes))} devices, "
                         f"have {have}")
    return n_data, total


def train_layout(cfg, mcfg, model, mesh) -> Tuple[Optional[Callable], Optional[StateLayout]]:
    """The forward (``apply_fn``, None for the model's own) and this rank's
    ``StateLayout`` of ``model`` (whole weights, alike on every rank) under
    ``mesh`` and ``cfg.fsdp``, after ``sod_tpu``'s checks of the layout and
    of ``fsdp`` (``assert_fsdp_compatible``)."""
    assert_fsdp_compatible(cfg, mesh)
    kind = mesh_kind(mesh)
    level = getattr(cfg, "fsdp", "none")
    if kind in (None, "data"):
        return None, (None if mesh is None else StateLayout(model, mesh, level))
    n_micro = getattr(cfg, "pp_microbatches", 0) or None
    depth = mcfg.vit.depth
    if kind == "tp":
        from sod_tpu_torch.parallel.tp import assert_tp_compatible, make_tp_apply, shard_params

        assert_tp_compatible(cfg, mesh)
        return make_tp_apply(mesh), shard_params(model, mesh, level)
    if mcfg.arch != "vit_small":
        raise ValueError(f"the {kind} layout pipelines or token-shards the ViT encoder; "
                         f"arch is {mcfg.arch!r}")
    if kind == "pp":
        from sod_tpu_torch.parallel.mesh import axis_size
        from sod_tpu_torch.parallel.pp import assert_pp_compatible, make_pp_apply, shard_params_pp

        assert_pp_compatible(cfg, mesh, n_micro or axis_size(mesh, "pipe"))
        return make_pp_apply(mesh, n_micro), shard_params_pp(model, mesh, depth, level)
    if kind == "sp":
        from sod_tpu_torch.parallel.sp import SEQ_PARTIAL, assert_sp_compatible, make_sp_apply

        assert_sp_compatible(cfg, mesh)
        return make_sp_apply(mesh), StateLayout(model, mesh, level, partial=SEQ_PARTIAL)
    if kind == "p3":
        from sod_tpu_torch.parallel.p3 import assert_p3_compatible, make_p3_apply, shard_params_p3

        assert_p3_compatible(cfg, mesh, mcfg.vit)
        return make_p3_apply(mesh, n_micro), shard_params_p3(model, mesh, depth, level)
    from sod_tpu_torch.parallel.sptp import (assert_sptp_compatible, make_sptp_apply,
                                             shard_params_sptp)

    assert_sptp_compatible(cfg, mesh, mcfg.vit)
    return make_sptp_apply(mesh), shard_params_sptp(model, mesh, level)


def eval_layout(cfg, mcfg, model, mesh):
    """The Evaluator's forward on ``mesh`` (``sod_tpu``'s: heads over a
    ``model`` axis, tokens over a ``seq`` axis, a ``pipe`` axis whole):
    (the model to run, holding this rank's shards, or ``model`` itself; the
    canvas hooks ``encoder_apply`` and ``layer_apply``, None for the model's
    own)."""
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if "model" in names and "seq" in names:
        from sod_tpu_torch.parallel.sptp import (assert_sptp_compatible, make_sptp_apply,
                                                 sptp_param_shardings)

        assert_sptp_compatible(cfg, mesh, mcfg.vit)
        apply_fn = make_sptp_apply(mesh)
        return mp_local_copy(model, mesh, sptp_param_shardings(model, mesh)), apply_fn
    if "model" in names:
        from sod_tpu_torch.parallel.tp import (assert_tp_compatible, make_tp_apply,
                                               param_shardings)

        assert_tp_compatible(cfg, mesh)
        return mp_local_copy(model, mesh, param_shardings(model, mesh)), make_tp_apply(mesh)
    if "seq" in names:
        from sod_tpu_torch.parallel.sp import assert_sp_compatible, make_sp_apply

        assert_sp_compatible(cfg, mesh)
        return model, make_sp_apply(mesh)
    return model, None
