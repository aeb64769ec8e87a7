"""3-D mesh: data x pipeline x tensor parallelism on a ``(data, pipe,
model)`` mesh (twin of ``sod_tpu/parallel/p3.py``).

The GPipe schedule of ``parallel/pp.py`` runs each stage's blocks
tensor-parallel: ``pp._pipeline_blocks`` with ``tp.block_apply`` as its
``block_fn``, whose "f" and "g" over ``model`` run inside the stage, forward
and backward, while the stages hand tokens on over ``pipe``.  A block leaf
is held by its pipe stage and, for the Megatron leaves, only its model
shard; the decoder and heads are whole and run alike on every rank.

The split layout.  ``sod_tpu`` stores the packed ``attn.qkv`` split into
``attn.q/k/v`` so that a contiguous model shard of each is a head group
(``p3_split_blocks``; ``p3_merge_blocks`` is its inverse).  The port cuts a
packed leaf the same way in place (``fsdp.model_shard``: each third's
shard, concatenated), so a rank's ``qkv`` rows are the merge of its q, k
and v shards: ``p3_block_specs`` gives the split leaves' specs and
``p3_param_shardings`` reads the packed leaf's from its q.  A checkpoint is
the one packed state under every layout (``p3_host_params``, the Trainer's
``full_state``), so any layout resumes it.  Plain PyTorch path only.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

import torch

from sod_tpu_torch.models.vit import prepare_tokens
from sod_tpu_torch.parallel.fsdp import StateLayout
from sod_tpu_torch.parallel.mesh import assert_xla_path, axis_size, make_mesh_nd
from sod_tpu_torch.parallel.pp import _pipeline_blocks
from sod_tpu_torch.parallel.tp import (_row_parallel, block_apply, check_divisible,  # noqa: F401
                                       maskformer_apply_fn, require_plain_blocks, require_shards)

_QKV = re.compile(r"^(.*blocks\.\d+\.attn\.)qkv\.(weight|bias)$")
_SPLIT = re.compile(r"^(.*blocks\.\d+\.attn\.)([qkv])\.(weight|bias)$")
_BLOCK = re.compile(r"^(?:.*\.)?blocks\.\d+\.(.*)$")


def make_mesh_3d(n_data: Optional[int] = None, n_pipe: int = 1, n_model: int = 1,
                 device="cuda"):
    """A ``(data, pipe, model)`` mesh.  ``n_data=None`` takes the ranks left
    after the pipe and model axes; ``sod_tpu``'s ``ValueError``s before any
    rendezvous."""
    return make_mesh_nd(n_data, (n_pipe, n_model), ("pipe", "model"), device,
                        "n_pipe/n_model")


# --------------------------------------------------------------- layout

def p3_split_blocks(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Packed state -> split layout: each block's ``attn.qkv.weight`` (3D, D)
    and ``.bias`` become ``attn.q/k/v`` (D, D) and (D,), so that a contiguous
    model shard of each is a head group; every other entry as it is.
    Lossless: ``p3_merge_blocks`` is the exact inverse."""
    out = {}
    for key, value in state.items():
        m = _QKV.match(key)
        if m is None:
            out[key] = value
            continue
        for name, part in zip("qkv", value.chunk(3, 0)):
            out[f"{m.group(1)}{name}.{m.group(2)}"] = part
    return out


def p3_merge_blocks(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Split layout -> packed state (inverse of ``p3_split_blocks``)."""
    out = {}
    for key, value in state.items():
        m = _SPLIT.match(key)
        if m is None:
            out[key] = value
        elif m.group(2) == "q":
            pre, kind = m.group(1), m.group(3)
            out[f"{pre}qkv.{kind}"] = torch.cat([state[f"{pre}{n}.{kind}"] for n in "qkv"])
    return out


def p3_is_split(state: Mapping[str, torch.Tensor]) -> bool:
    return any(_SPLIT.match(k) for k in state)


_COLUMN_SPLIT = re.compile(r"^attn\.[qkv]\.(weight|bias)$|^mlp\.fc1\.(weight|bias)$")
_ROW_SPLIT = re.compile(r"^(attn\.proj|mlp\.fc2)\.weight$")


def p3_block_specs(split_state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Dict[str, Optional[int]]]:
    """The specs of the split layout's block leaves on a (data, pipe, model)
    mesh: every leaf's layer axis over ``pipe``; the Megatron rules place
    ``model``: q/k/v and mlp.fc1 shard their output rows (biases with them),
    proj and mlp.fc2 their input columns (biases whole, added once after
    "g"); the norms are whole.  Keys: ``split_state``'s block entries."""
    out = {}
    for key in split_state:
        m = _BLOCK.match(key)
        if m is None:
            continue
        leaf = m.group(1)
        if _COLUMN_SPLIT.match(leaf):
            out[key] = {"pipe": None, "model": 0}
        elif _ROW_SPLIT.match(leaf):
            out[key] = {"pipe": None, "model": 1}
        else:
            out[key] = {"pipe": None}
    return out


def _packed_specs(model: torch.nn.Module, split_specs) -> Dict[str, Dict[str, Optional[int]]]:
    """``split_specs`` read back onto ``model``'s packed names (a ``qkv``
    leaf takes its q's spec); every other leaf whole."""
    out = {}
    for name, _ in model.named_parameters():
        m = _QKV.match(name)
        key = f"{m.group(1)}q.{m.group(2)}" if m else name
        out[name] = dict(split_specs.get(key, {}))
    return out


def p3_param_shardings(model: torch.nn.Module, mesh, depth: int
                       ) -> Dict[str, Dict[str, Optional[int]]]:
    """The specs of ``model``'s parameters on a (data, pipe, model) mesh:
    the encoder blocks per ``p3_block_specs`` (``model`` dropped at a model
    axis of 1), everything else whole (the decoder and heads run alike on
    every rank, as in ``pp``)."""
    n_pipe = axis_size(mesh, "pipe")
    if n_pipe > 1 and depth % n_pipe != 0:
        raise ValueError(f"depth {depth} not divisible by pipe axis {n_pipe}")
    split = p3_split_blocks({n: p for n, p in model.named_parameters()
                             if n.startswith("encoder.blocks.")})
    specs = p3_block_specs(split)
    if axis_size(mesh, "model") <= 1:
        specs = {k: {a: v for a, v in s.items() if a != "model"} for k, s in specs.items()}
    return _packed_specs(model, specs)


def shard_params_p3(model: torch.nn.Module, mesh, depth: int, level: str = "none",
                    **kw) -> StateLayout:
    """Each rank keeps its pipe stage's blocks of ``model``, their Megatron
    leaves cut to its model shard (in place); the returned layout holds
    them."""
    return StateLayout(model, mesh, level, mp=p3_param_shardings(model, mesh, depth), **kw)


def p3_host_params(params) -> Dict[str, torch.Tensor]:
    """A host copy in the standard packed layout: of a ``StateLayout``'s
    whole weights (collective), or of a state dict, merged if it is split."""
    if isinstance(params, Mapping):
        state = p3_merge_blocks(params) if p3_is_split(params) else dict(params)
    else:
        with params.gathered():
            state = dict(params.model.state_dict())
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def assert_p3_compatible(cfg, mesh, vit_cfg) -> None:
    """Fail loudly on configs the 3-D mesh path does not cover (``sod_tpu``'s
    checks and messages)."""
    n_model, n_pipe = axis_size(mesh, "model"), axis_size(mesh, "pipe")
    if n_model <= 1 or n_pipe <= 1:
        return
    assert_xla_path(
        cfg, "the (data, pipe, model) mesh requires the XLA path",
        "the stage program is explicit shard_map "
        "(see parallel/p3.py docstring)")
    if vit_cfg.depth % n_pipe != 0:
        raise ValueError(f"depth {vit_cfg.depth} not divisible by pipe axis {n_pipe}")
    check_divisible(vit_cfg.n_heads, vit_cfg.embed_dim, 4 * vit_cfg.embed_dim, n_model)


# -------------------------------------------------------- stage program

def _block_apply_tp(blk, x: torch.Tensor, cfg, key_mask: Optional[torch.Tensor],
                    group) -> torch.Tensor:
    """One block tensor-parallel over ``group`` (``tp.block_apply``), run
    inside the GPipe stage."""
    return block_apply(blk, x, cfg, key_mask, group)


def p3_vit_apply(vit, x: torch.Tensor, mesh, n_micro: Optional[int] = None,
                 all_layers: bool = True, token_mask: Optional[torch.Tensor] = None,
                 pos_embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vit_apply`` with the block stack pipelined over ``pipe`` and
    tensor-parallel over ``model`` (``vit``'s weights: this rank's shards,
    ``shard_params_p3``)."""
    cfg = vit.cfg
    require_plain_blocks(cfg, "p3_vit_apply", "p3")
    require_shards(vit, mesh, "p3_vit_apply needs the TP-split block layout — "
                              "shard with parallel.shard_params_p3 first")
    if n_micro is None:
        n_micro = axis_size(mesh, "pipe")
    group = mesh.get_group("model")
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    return _pipeline_blocks(vit, tokens, mesh, n_micro, token_mask,
                            block_fn=lambda blk, h, km: _block_apply_tp(blk, h, cfg, km, group),
                            all_layers=all_layers)


def make_p3_apply(mesh, n_micro: Optional[int] = None) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` whose ViT
    encoder runs pipelined and tensor-parallel over ``mesh``; the decoder and
    heads run alike on every rank, as in the pp path."""
    def encoder_apply(vit, x, token_mask=None, pos_embed_override=None):
        return p3_vit_apply(vit, x, mesh, n_micro, all_layers=False, token_mask=token_mask,
                            pos_embed_override=pos_embed_override)

    return maskformer_apply_fn(encoder_apply)
