"""Sequence x tensor parallelism: ring attention inside Megatron groups on a
``(data, seq, model)`` mesh (twin of ``sod_tpu/parallel/sptp.py``).

Each rank holds its model shard of the encoder blocks' Megatron leaves (the
split layout's specs of ``parallel/p3.py`` without the pipe axis) and runs
its token slice of every block (``sp._ring_blocks`` with the model group):
"f", the q/k/v of its head group, ``ring_attention`` over ``seq`` on those
heads (the online softmax is per head, so the two shardings compose), the
row-parallel proj and MLP with "g" over ``model``.  The decoder and heads
are whole and run alike on every rank.  An encoder leaf's gradient is the
part of this rank's token slice and is summed over ``seq``
(``sp.SEQ_PARTIAL``).  Plain PyTorch path only.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from sod_tpu_torch.parallel.fsdp import StateLayout
from sod_tpu_torch.parallel.mesh import assert_xla_path, axis_size, make_mesh_nd
from sod_tpu_torch.parallel.p3 import _packed_specs, p3_block_specs, p3_split_blocks
from sod_tpu_torch.parallel.sp import SEQ_PARTIAL, _ring_blocks, ring_tokens
from sod_tpu_torch.parallel.tp import (check_divisible, maskformer_apply_fn, require_plain_blocks,
                                       require_shards)


def make_mesh_sptp(n_data: Optional[int] = None, n_seq: int = 1, n_model: int = 1,
                   device="cuda"):
    """A ``(data, seq, model)`` mesh.  ``n_data=None`` takes the ranks left
    after the seq and model axes; ``sod_tpu``'s ``ValueError``s before any
    rendezvous."""
    return make_mesh_nd(n_data, (n_seq, n_model), ("seq", "model"), device, "n_seq/n_model")


def sptp_block_specs(split_state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, Dict[str, Optional[int]]]:
    """``p3_block_specs`` with the layer axis whole (no pipe here)."""
    return {k: {a: v for a, v in s.items() if a != "pipe"}
            for k, s in p3_block_specs(split_state).items()}


def sptp_param_shardings(model: torch.nn.Module, mesh) -> Dict[str, Dict[str, Optional[int]]]:
    """The specs of ``model``'s parameters on a (data, seq, model) mesh: the
    encoder blocks per ``sptp_block_specs`` (all whole at a model axis of
    1), everything else whole."""
    split = p3_split_blocks({n: p for n, p in model.named_parameters()
                             if n.startswith("encoder.blocks.")})
    specs = sptp_block_specs(split) if axis_size(mesh, "model") > 1 else {}
    return _packed_specs(model, specs)


def shard_params_sptp(model: torch.nn.Module, mesh, level: str = "none", **kw) -> StateLayout:
    """Each rank keeps its model shard of ``model``'s block leaves (in
    place); the returned layout holds them and sums the encoder's
    gradients over ``seq``."""
    return StateLayout(model, mesh, level, mp=sptp_param_shardings(model, mesh),
                       partial=SEQ_PARTIAL, **kw)


def assert_sptp_compatible(cfg, mesh, vit_cfg) -> None:
    """Fail loudly on configs the (data, seq, model) mesh does not cover
    (``sod_tpu``'s checks and messages)."""
    n_model = axis_size(mesh, "model")
    if n_model <= 1 or axis_size(mesh, "seq") <= 1:
        return
    assert_xla_path(
        cfg, "the (data, seq, model) mesh requires the XLA path",
        "the ring-TP stage program is explicit shard_map "
        "(see parallel/sptp.py docstring)")
    check_divisible(vit_cfg.n_heads, vit_cfg.embed_dim, 4 * vit_cfg.embed_dim, n_model)


def sptp_vit_apply(vit, x: torch.Tensor, mesh, all_layers: bool = True,
                   token_mask: Optional[torch.Tensor] = None,
                   pos_embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vit_apply`` with tokens sharded over ``seq`` (ring attention) and
    heads over ``model`` (Megatron; ``vit``'s weights: this rank's shards,
    ``shard_params_sptp``)."""
    require_plain_blocks(vit.cfg, "sptp_vit_apply", "sptp")
    require_shards(vit, mesh, "sptp_vit_apply needs the TP-split block layout "
                              "— shard with parallel.shard_params_sptp first")
    tokens, mask, t = ring_tokens(vit, x, mesh, token_mask, pos_embed_override)
    stack = _ring_blocks(vit, tokens, mask, mesh, all_layers=all_layers,
                         model_group=mesh.get_group("model"))
    return stack[..., :t, :]


def make_sptp_apply(mesh) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` whose ViT
    encoder runs token-sharded and tensor-parallel over ``mesh``, and its
    canvas hook ``encoder_apply``; the decoder and heads run alike on every
    rank, as in the sp path."""
    def encoder_apply(vit, x, token_mask=None, pos_embed_override=None):
        return sptp_vit_apply(vit, x, mesh, all_layers=False, token_mask=token_mask,
                              pos_embed_override=pos_embed_override)

    return maskformer_apply_fn(encoder_apply)
