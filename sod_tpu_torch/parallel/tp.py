"""Tensor parallelism on a ``(data, model)`` mesh (twin of
``sod_tpu/parallel/tp.py``).

``sod_tpu`` only annotates the weights with Megatron's ``PartitionSpec``s
and lets GSPMD place the collectives.  Here the rules pick the same leaves,
on the port's (out, in) layout (``reference_layout`` maps them), and each
rank keeps its shard of them (``shard_params``, a ``StateLayout``); the
forward then runs Megatron's collectives by hand (``parallel/comm.py``):

* column-parallel, the output rows shard: ``attn.qkv`` and the decoder's
  ``in_proj`` (packed ``[q|k|v]``: the same rows of each third),
  ``mlp.fc1`` and ``linear1``, biases with them.  "f" (``copy_to_group``)
  stands before them;
* row-parallel, the input columns shard: ``attn.proj``, ``out_proj``,
  ``mlp.fc2``, ``linear2``.  "g" (``reduce_from_group``) sums their partial
  products, then the whole bias is added once;
* everything else is whole on every rank: LayerNorms, embeddings, the
  patch projection, the heads, a ResNet encoder.

A leaf whose axis the ``model`` size does not divide stays whole, as in
``sod_tpu`` (a packed leaf when its thirds do not divide), and so does its
partner: ``qkv``/``proj``, ``fc1``/``fc2``, ``in_proj``/``out_proj`` and
``linear1``/``linear2`` each share one width.  ``sod_tpu``'s GSPMD runs
whatever the specs give; here the encoder blocks and the decoder layers
(``make_tp_apply``) pick a path per pair from what this rank holds:

1. the model size divides the layer's heads: each rank runs its own heads
   between "f" and "g";
2. the q/k/v shards cut a head (ViT-S's 6 heads at model 4, 1.5 a rank):
   the column-parallel product on the local rows; q, k and v gathered over
   the group on the feature axis in rank order (``comm.gather_along``: a
   rank's rows of a third are its contiguous shard of it, so each gathered
   third is whole); attention over every head on every rank; then "f" on its
   output, this rank's columns of it, the row-parallel product and "g".
   "f" stands before the narrow because ``gather_along``'s backward hands
   each rank its slice of a gradient that must be alike on every rank:
   without it a rank's gradient of the attention output holds only its own
   columns, and dq, dk, dv would be that rank's part of the sum;
3. the pair stays whole: every rank runs it whole, with no "f" and no "g".
   Its leaves are replicated ones, whose gradient ``StateLayout`` counts
   once.

Everything after a "g" is computed alike on every rank of the group, so the
loss is, and a replicated leaf's gradient is the same on every rank.  p3
and sptp refuse heads that the model axis cuts, as ``sod_tpu`` does, so
under them ``block_apply`` takes path 1.  Plain PyTorch path only
(``assert_tp_compatible``): the kernels are single-shard programs.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch

import torch.distributed as dist

from sod_tpu_torch.models.vit import MLP_RATIO, prepare_tokens
from sod_tpu_torch.ops.attention import _merge_heads, _split_heads, sdpa
from sod_tpu_torch.ops.layers import gelu, linear
from sod_tpu_torch.parallel.comm import copy_to_group, gather_along, reduce_from_group
from sod_tpu_torch.parallel.fsdp import _PACKED, StateLayout, fsdp_specs
from sod_tpu_torch.parallel.mesh import assert_xla_path, axis_size, make_mesh_nd

# parameters whose OUTPUT rows shard over "model"
_COLUMN = re.compile(r"(attn\.qkv|mlp\.fc1|linear1)\.(weight|bias)$|in_proj_(weight|bias)$")
# parameters whose INPUT columns shard over "model" (their biases stay whole)
_ROW = re.compile(r"(attn\.proj|mlp\.fc2|out_proj|linear2)\.weight$")


def make_mesh_2d(n_data: Optional[int] = None, n_model: int = 1, device="cuda"):
    """A ``(data, model)`` mesh.  ``n_data=None`` takes the ranks left after
    the model axis; ``sod_tpu``'s ``ValueError``s before any rendezvous."""
    return make_mesh_nd(n_data, (n_model,), ("model",), device, "n_model")


def tp_specs(model: torch.nn.Module, n_model: int,
             names: Optional[re.Pattern] = None) -> Dict[str, Dict[str, int]]:
    """{parameter name: {"model": the port's axis it shards}} under
    ``n_model``-way tensor parallelism ({} for a whole leaf; all {} at
    ``n_model=1``).  Read ``model``'s whole weights.

    :param names: only parameters whose name it matches may shard."""
    out = {}
    for name, p in model.named_parameters():
        spec = {}
        if n_model > 1 and (names is None or names.search(name)):
            if _COLUMN.search(name):
                rows = p.shape[0] // 3 if _PACKED.search(name) else p.shape[0]
                if rows % n_model == 0:
                    spec = {"model": 0}
            elif _ROW.search(name) and p.dim() == 2 and p.shape[1] % n_model == 0:
                spec = {"model": 1}
        out[name] = spec
    return out


def param_shardings(model: torch.nn.Module, mesh) -> Dict[str, Dict[str, int]]:
    """``tp_specs`` of the mesh's model size (all whole without a model axis)."""
    return tp_specs(model, axis_size(mesh, "model"))


def shard_params(model: torch.nn.Module, mesh, level: str = "none", **kw) -> StateLayout:
    """Each rank keeps its tensor-parallel shard of ``model``'s weights (in
    place); the returned layout holds them (``level``: ``Config.fsdp``)."""
    return StateLayout(model, mesh, level, mp=param_shardings(model, mesh), **kw)


def opt_state_shardings(model: torch.nn.Module, mesh, param_specs=None,
                        level: str = "none") -> Dict[str, Dict[str, Optional[int]]]:
    """The moments' layout: each mirrors its parameter's (``param_specs``,
    default ``param_shardings``); under ``zero1`` it adds ``data`` on the
    axis ``sod_tpu`` adds (``zero1_moment_shardings``).  Read ``model``'s
    whole weights."""
    mp = param_shardings(model, mesh) if param_specs is None else param_specs
    data = fsdp_specs(model, mesh, mp=mp) if level == "zero1" else {}
    return {name: dict(mp.get(name, {}), **({"data": data[name]}
                                            if data.get(name) is not None else {}))
            for name, _ in model.named_parameters()}


def shard_opt_state(layout: StateLayout, opt_state: Dict) -> Dict:
    """This rank's share of a whole optimizer state (a restored checkpoint),
    laid out like ``layout``'s tensors."""
    return layout.local_opt_state(opt_state)


def assert_tp_compatible(cfg, mesh) -> None:
    """Fail loudly when a >1 model axis meets a kernel path (``sod_tpu``'s
    check and message).  Any heads and widths run (the module's paths)."""
    n_model = axis_size(mesh, "model")
    if n_model <= 1:
        return
    assert_xla_path(
        cfg,
        f"tensor parallelism (model axis {n_model}) requires the XLA path",
        "Pallas kernels are single-shard programs (wrapping them in "
        "shard_map is future work, see docs/PERFORMANCE.md)")


def check_divisible(n_heads: int, embed_dim: int, hidden: int, n_model: int) -> None:
    """``sod_tpu``'s Megatron check and message (``p3.py``, ``sptp.py``)."""
    for name, dim in (("n_heads", n_heads), ("embed_dim", embed_dim),
                      ("mlp hidden", hidden)):
        if dim % n_model != 0:
            raise ValueError(
                f"{name} {dim} not divisible by model axis {n_model} — "
                "Megatron head/feature sharding needs even splits")


def require_plain_blocks(cfg, fn: str, module: str) -> None:
    """The layouts' forwards run the plain block (``sod_tpu``'s message)."""
    if cfg.use_flash or cfg.fused_mlp or cfg.fused_train:
        raise ValueError(
            f"{fn} requires the XLA block path "
            f"(use_flash/fused_mlp/fused_train off) — see parallel/{module}.py")


def require_shards(vit, mesh, message: str) -> None:
    """Raise ``message`` unless ``vit``'s blocks hold this rank's model
    shards (whole blocks at a model axis of 1, or of one that does not
    divide the width, as ``tp_specs`` leaves them; a block off this rank's
    pipe stage holds nothing)."""
    d, n_model = vit.cfg.embed_dim, axis_size(mesh, "model")
    rows = 3 * (d // n_model if d % n_model == 0 else d)
    if any(blk.attn.qkv.weight.shape[0] not in (0, rows) for blk in vit.blocks):
        raise ValueError(message)


# ------------------------------------------------------------ the forward

def _row_parallel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  group) -> torch.Tensor:
    """Local partial product, summed over ``group`` ("g"), then the whole
    bias: ``ops.layers.linear``'s f32 accumulation and rounding points."""
    y = torch.matmul(x.float(), w.to(x.dtype).float().t())
    if group is not None:
        y = reduce_from_group(y, group)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _column(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else copy_to_group(x, group)


def _pair_group(local: int, whole: int, group):
    """The group a column/row pair runs over: None when this rank holds the
    pair whole (``local`` rows of its ``whole``-row column leaf; path 3)."""
    return None if local == whole else group


def _cut_heads_out(out: torch.Tensor, rows: int, group) -> torch.Tensor:
    """Path 2's attention output [B, N, D], alike on every rank: "f", then
    this rank's ``rows`` columns of it (its row-parallel input)."""
    return copy_to_group(out, group).narrow(-1, dist.get_rank(group) * rows, rows)


def block_apply(blk, x: torch.Tensor, cfg, key_mask: Optional[torch.Tensor] = None,
                group=None, attend: Optional[Callable] = None) -> torch.Tensor:
    """One encoder block (``Block.forward``'s math) tensor-parallel over
    ``group`` (no collective when None), on the path this rank's shards
    call for (the module's 1-3).

    :param attend: ``(q, k, v, scale, key_mask) -> out`` over [B, h, N, hd]
        (default ``sdpa``; the ring of ``parallel/sp.py`` under a seq axis)."""
    attend = attend or sdpa
    d = cfg.embed_dim
    hd = d // cfg.n_heads
    b, n, _ = x.shape
    rows = blk.attn.qkv.weight.shape[0] // 3          # this rank's rows of q, of k, of v
    g = _pair_group(rows, d, group)
    y = linear(_column(blk.norm1(x), g), blk.attn.qkv.weight, blk.attn.qkv.bias)
    if rows % hd == 0:
        y = y.reshape(b, n, 3, rows // hd, hd)
        q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
        out = _merge_heads(attend(q, k, v, hd ** -0.5, key_mask))
    else:
        y = gather_along(y.reshape(b, n, 3, rows), -1, g).reshape(b, n, 3, cfg.n_heads, hd)
        q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
        out = _cut_heads_out(_merge_heads(attend(q, k, v, hd ** -0.5, key_mask)), rows, g)
    x = x + _row_parallel(out, blk.attn.proj.weight, blk.attn.proj.bias, g)
    g = _pair_group(blk.mlp.fc1.weight.shape[0], MLP_RATIO * d, group)
    u = gelu(linear(_column(blk.norm2(x), g), blk.mlp.fc1.weight, blk.mlp.fc1.bias))
    return x + _row_parallel(u, blk.mlp.fc2.weight, blk.mlp.fc2.bias, g)


def tp_vit_apply(vit, x: torch.Tensor, mesh, all_layers: bool = False,
                 token_mask: Optional[torch.Tensor] = None,
                 pos_embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vit_apply`` with every block tensor-parallel over ``mesh``'s model
    axis (``vit``'s weights: this rank's shards)."""
    cfg = vit.cfg
    require_plain_blocks(cfg, "tp_vit_apply", "tp")
    require_shards(vit, mesh, "tp_vit_apply needs the tensor-parallel shards — "
                              "shard with parallel.shard_params first")
    group = mesh.get_group("model")
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    per_layer = []
    for blk in vit.blocks:
        tokens = block_apply(blk, tokens, cfg, token_mask, group)
        if all_layers:
            per_layer.append(vit.norm(tokens))
    return torch.stack(per_layer) if all_layers else vit.norm(tokens)


def _mha(attn, query, key, value, key_mask, group) -> torch.Tensor:
    """``multi_head_attention`` from this rank's packed ``in_proj`` rows,
    the row-parallel ``out_proj`` summed over ``group``, on the path those
    rows call for (the module's 1-3)."""
    d = attn.in_proj_weight.shape[1]
    hd = d // attn.n_heads
    rows = attn.in_proj_weight.shape[0] // 3
    g = _pair_group(rows, d, group)
    w, bias = attn.in_proj_weight, attn.in_proj_bias
    q, k, v = (linear(_column(t, g), w[i * rows:(i + 1) * rows], bias[i * rows:(i + 1) * rows])
               for i, t in enumerate((query, key, value)))
    if rows % hd == 0:
        out = _merge_heads(sdpa(*(_split_heads(t, rows // hd) for t in (q, k, v)),
                                hd ** -0.5, key_mask))
    else:
        q, k, v = (_split_heads(gather_along(t, -1, g), attn.n_heads) for t in (q, k, v))
        out = _cut_heads_out(_merge_heads(sdpa(q, k, v, hd ** -0.5, key_mask)), rows, g)
    return _row_parallel(out, attn.out_proj.weight, attn.out_proj.bias, g)


def decoder_layer_apply(layer, tgt, memory, query_pos, memory_mask=None, group=None):
    """``DecoderLayer.forward`` tensor-parallel over ``group``."""
    qk = tgt + query_pos
    tgt = layer.norm1(tgt + _mha(layer.self_attn, qk, qk, tgt, None, group))
    tgt = layer.norm2(tgt + _mha(layer.multihead_attn, tgt + query_pos, memory, memory,
                                 memory_mask, group))
    w1 = layer.linear1.weight
    g = _pair_group(w1.shape[0], 4 * w1.shape[1], group)     # DecoderLayer's 4 * d
    h = torch.relu(linear(_column(tgt, g), w1, layer.linear1.bias))
    return layer.norm3(tgt + _row_parallel(h, layer.linear2.weight, layer.linear2.bias, g))


def maskformer_apply_fn(encoder_apply: Callable, layer_apply: Optional[Callable] = None
                       ) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` through
    these hooks (``make_train_step(apply_fn=...)``, ``make_eval_step``),
    carrying them as attributes for the Evaluator's canvas forward."""
    def apply_fn(model, x, train: bool = False):
        return model(x, train=train, encoder_apply=encoder_apply, layer_apply=layer_apply)

    apply_fn.encoder_apply, apply_fn.layer_apply = encoder_apply, layer_apply
    return apply_fn


def make_tp_apply(mesh) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` whose
    encoder blocks and decoder layers run tensor-parallel over ``mesh``
    (``make_train_step(apply_fn=...)``, ``make_eval_step``), and its canvas
    hooks (``encoder_apply``, ``layer_apply``) for the Evaluator."""
    group = mesh.get_group("model")

    def encoder_apply(vit, x, token_mask=None, pos_embed_override=None):
        return tp_vit_apply(vit, x, mesh, token_mask=token_mask,
                            pos_embed_override=pos_embed_override)

    def layer_apply(layer, tgt, memory, query_pos, memory_mask=None):
        return decoder_layer_apply(layer, tgt, memory, query_pos, memory_mask, group)

    return maskformer_apply_fn(encoder_apply, layer_apply)

