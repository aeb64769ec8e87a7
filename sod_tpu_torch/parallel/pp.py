"""Pipeline parallelism (GPipe) over the ViT block stack on a ``(data,
pipe)`` mesh (twin of ``sod_tpu/parallel/pp.py``).

Pipe rank r holds the blocks ``[r L/S, (r+1) L/S)`` (``pp_specs``; the
others hold no storage on it) and everything else whole.  The batch splits
into ``M`` micro-batches (default ``S``); the loop runs ``M + S - 1`` ticks,
stage s working on micro-batch ``t - s`` at tick t and handing its output to
stage s + 1 through ``parallel/comm.py``'s exchange, the forward of
``ppermute``.  Bubble ticks compute nothing (``sod_tpu`` computes them on
zeros and masks the result: it is never read).

The schedule is one autograd Function, ``_GPipe``: its forward keeps each
micro-batch's stage graph, its backward walks the ticks the other way and
hands every gradient back one stage with the reversed exchange, which is
``ppermute``'s backward.  Autograd cannot drive the pipe's exchanges itself:
a tick whose stage only sends has no output that the loss reads, so
autograd would skip its backward and the peer would wait for ever.

Output: the last stage's tokens reach every pipe rank (a broadcast, or with
``all_layers`` an all-gather of every stage's layers); the final LayerNorm,
decoder, heads and loss then run alike on every pipe rank, and the tokens'
gradient, alike on every rank, is read once, on the stage that made them.
The tokens' gradient is broadcast back from stage 0, so the embeddings'
gradients are alike on every pipe rank too.  Plain PyTorch path only
(``assert_pp_compatible``, ``pp_vit_apply``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from sod_tpu_torch.models.vit import prepare_tokens
from sod_tpu_torch.parallel.comm import exchange
from sod_tpu_torch.parallel.fsdp import StateLayout, _STACKED
from sod_tpu_torch.parallel.mesh import (all_gather_into, assert_xla_path, axis_rank, axis_size,
                                         data_size, make_mesh_nd)
from sod_tpu_torch.parallel.tp import maskformer_apply_fn, require_plain_blocks


def make_mesh_pp(n_data: Optional[int] = None, n_pipe: int = 1, device="cuda"):
    """A ``(data, pipe)`` mesh.  ``n_data=None`` takes the ranks left after
    the pipe axis; ``sod_tpu``'s ``ValueError``s before any rendezvous."""
    return make_mesh_nd(n_data, (n_pipe,), ("pipe",), device, "n_pipe")


def pp_specs(model: torch.nn.Module, n_pipe: int, depth: int
             ) -> Dict[str, Dict[str, Optional[int]]]:
    """{parameter name: {"pipe": None}} for every encoder block leaf (its
    layer axis shards over ``pipe``) when ``n_pipe`` > 1 divides ``depth``;
    {} for every other leaf (the decoder's layers stay whole)."""
    out = {}
    for name, _ in model.named_parameters():
        m = _STACKED.match(name)
        stacked = m is not None and m.group(1) == "encoder.blocks"
        out[name] = ({"pipe": None} if stacked and n_pipe > 1 and depth % n_pipe == 0
                     else {})
    return out


def pp_param_shardings(model: torch.nn.Module, mesh, depth: int):
    """``pp_specs`` of the mesh's pipe size."""
    return pp_specs(model, axis_size(mesh, "pipe"), depth)


def shard_params_pp(model: torch.nn.Module, mesh, depth: int, level: str = "none",
                    **kw) -> StateLayout:
    """Each pipe rank keeps its stage's blocks of ``model`` (in place); the
    returned layout holds them."""
    return StateLayout(model, mesh, level, mp=pp_param_shardings(model, mesh, depth), **kw)


def assert_pp_compatible(cfg, mesh, n_micro: int) -> None:
    """Fail loudly on configs the pipelined path does not cover
    (``sod_tpu``'s checks and messages)."""
    if axis_size(mesh, "pipe") <= 1:
        return
    assert_xla_path(
        cfg,
        f"pipeline parallelism (pipe axis {axis_size(mesh, 'pipe')}) requires "
        "the XLA path",
        "the pipelined stage program is validated on XLA ops only "
        "(see parallel/pp.py docstring)")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")


def _schedule(run: Callable, micro: List[torch.Tensor], masks, group, s: int, n_stages: int,
              keep_graph: bool):
    """The forward ticks of stage ``s``: per micro-batch, its input (a leaf
    when ``keep_graph``) and the stage's per-layer outputs."""
    n_micro = len(micro)
    saved: Dict[int, tuple] = {}
    recv = None
    for t in range(n_micro + n_stages - 1):
        m = t - s
        if 0 <= m < n_micro:
            x = micro[m] if s == 0 else recv
            if keep_graph:
                x = x.detach().requires_grad_(True)
            with torch.enable_grad() if keep_graph else contextlib.nullcontext():
                saved[m] = (x, run(x, masks[m]))
        if t < n_micro + n_stages - 2:
            # stage i hands micro-batch t - i on when it worked on one
            perm = [(i, i + 1) for i in range(n_stages - 1) if 0 <= t - i < n_micro]
            if any(s in p for p in perm):
                send = saved[m][1][-1].detach() if (s, s + 1) in perm else micro[0]
                recv = exchange(send, group, perm)
    return saved


def _assemble(saved, n_micro: int, group, s: int, n_stages: int, all_layers: bool,
              like: torch.Tensor) -> torch.Tensor:
    """Every pipe rank's copy of the result: the last stage's final tokens
    [B, T, D], or every stage's layers [L, B, T, D]."""
    if all_layers:
        mine = torch.stack([torch.cat([saved[m][1][j].detach() for m in range(n_micro)])
                            for j in range(len(saved[0][1]))])
        out = mine.new_empty((n_stages * mine.shape[0],) + tuple(mine.shape[1:]))
        all_gather_into(out, mine.contiguous(), group=group)
        return out
    if s == n_stages - 1:
        out = torch.cat([saved[m][1][-1].detach() for m in range(n_micro)]).contiguous()
    else:
        out = torch.empty_like(like)
    dist.broadcast(out, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, mask, run, group, n_micro, all_layers):
        s, n_stages = dist.get_rank(group), dist.get_world_size(group)
        micro = list(tokens.chunk(n_micro))
        masks = list(mask.chunk(n_micro)) if mask is not None else [None] * n_micro
        saved = _schedule(run, micro, masks, group, s, n_stages, keep_graph=True)
        ctx.saved, ctx.group, ctx.all_layers = saved, group, all_layers
        ctx.n_micro, ctx.like = n_micro, micro[0]
        return _assemble(saved, n_micro, group, s, n_stages, all_layers, tokens)

    @staticmethod
    def backward(ctx, g):
        group, n_micro, saved = ctx.group, ctx.n_micro, ctx.saved
        s, n_stages = dist.get_rank(group), dist.get_world_size(group)
        per_stage = len(saved[0][1])
        if ctx.all_layers:
            mine = g.narrow(0, s * per_stage, per_stage)
            g_out = {m: list(mine_m.unbind(0)) for m, mine_m in
                     enumerate(mine.chunk(n_micro, dim=1))}
        elif s == n_stages - 1:
            g_out = {m: [None] * (per_stage - 1) + [g_m]
                     for m, g_m in enumerate(g.chunk(n_micro))}
        else:
            g_out = {m: [None] * per_stage for m in range(n_micro)}
        g_in: List[Optional[torch.Tensor]] = [None] * n_micro
        recv = None
        # the forward ticks mirrored: stage s works on micro-batch m at tick
        # u when u - (S-1-s) = M-1-m, and hands its input's gradient back
        for u in range(n_micro + n_stages - 1):
            j = u - (n_stages - 1 - s)
            m = n_micro - 1 - j
            if 0 <= j < n_micro:
                x, outs = saved[m]
                grads = list(g_out[m])
                if s < n_stages - 1:
                    grads[-1] = recv if grads[-1] is None else grads[-1] + recv
                pairs = [(o, gr) for o, gr in zip(outs, grads) if gr is not None]
                torch.autograd.backward([o for o, _ in pairs], [gr for _, gr in pairs])
                g_in[m] = x.grad
                del saved[m]
            if u < n_micro + n_stages - 2:
                perm = [(i, i - 1) for i in range(1, n_stages)
                        if 0 <= u - (n_stages - 1 - i) < n_micro]
                if any(s in p for p in perm):
                    send = g_in[m] if (s, s - 1) in perm else ctx.like
                    recv = exchange(send, group, perm)
        if s == 0:
            g_tokens = torch.cat(g_in).contiguous()
        else:
            g_tokens = torch.empty((n_micro * ctx.like.shape[0],) + tuple(ctx.like.shape[1:]),
                                   dtype=ctx.like.dtype, device=ctx.like.device)
        dist.broadcast(g_tokens, src=dist.get_global_rank(group, 0), group=group)
        return g_tokens, None, None, None, None, None


def _pipeline_blocks(vit, tokens: torch.Tensor, mesh, n_micro: int,
                     token_mask: Optional[torch.Tensor] = None, block_fn=None,
                     all_layers: bool = False) -> torch.Tensor:
    """Run this stage's blocks of ``vit`` in the GPipe schedule over
    ``mesh``'s pipe axis.  Returns the final-LayerNormed tokens [B, 1+N, D],
    or with ``all_layers`` every layer's [L, B, 1+N, D]
    (``vit_apply(all_layers=True)``'s contract), on every pipe rank.

    :param block_fn: the per-block apply ``(blk, x, key_mask) -> x`` (default
        the block's own forward).  The 3-D mesh plugs in the tensor-parallel
        block here (``parallel/p3.py``); its collectives over ``model`` run
        inside the stage, forward and backward.
    """
    cfg = vit.cfg
    n_stages, s = axis_size(mesh, "pipe"), axis_rank(mesh, "pipe")
    depth = cfg.depth
    if depth % n_stages != 0:
        raise ValueError(f"depth {depth} not divisible by pipe axis {n_stages}")
    n_data = data_size(mesh)
    b_global = tokens.shape[0] * n_data
    if b_global % n_micro != 0:
        raise ValueError(f"batch {b_global} not divisible by n_micro {n_micro}")
    mb = b_global // n_micro
    if n_data > 1 and mb % n_data != 0:
        raise ValueError(
            f"micro-batch {mb} (batch {b_global} / n_micro {n_micro}) not divisible by "
            f"data axis {n_data}")
    k = depth // n_stages
    blocks = vit.blocks[s * k:(s + 1) * k]
    block_fn = block_fn or (lambda blk, x, km: blk(x, km))

    def run(x, km):
        outs = []
        for blk in blocks:
            x = block_fn(blk, x, km)
            outs.append(x)
        return outs

    group = mesh.get_group("pipe")
    mask = None if token_mask is None else token_mask.to(torch.bool)
    if torch.is_grad_enabled():
        out = _GPipe.apply(tokens, mask, run, group, n_micro, all_layers)
    else:
        micro = list(tokens.chunk(n_micro))
        masks = list(mask.chunk(n_micro)) if mask is not None else [None] * n_micro
        saved = _schedule(run, micro, masks, group, s, n_stages, keep_graph=False)
        out = _assemble(saved, n_micro, group, s, n_stages, all_layers, tokens)
    return vit.norm(out)


def pp_vit_apply(vit, x: torch.Tensor, mesh, n_micro: Optional[int] = None,
                 all_layers: bool = True, token_mask: Optional[torch.Tensor] = None,
                 pos_embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vit_apply`` with the block stack pipelined over ``mesh``'s pipe axis
    (GPipe, ``n_micro`` micro-batches; default the number of stages); the
    unfused ``vit_apply``'s math."""
    require_plain_blocks(vit.cfg, "pp_vit_apply", "pp")
    if n_micro is None:
        n_micro = axis_size(mesh, "pipe")
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    return _pipeline_blocks(vit, tokens, mesh, n_micro, token_mask, all_layers=all_layers)


def make_pp_apply(mesh, n_micro: Optional[int] = None) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` whose ViT
    encoder runs pipelined over ``mesh`` (``make_train_step(apply_fn=...)``);
    the decoder and heads run alike on every pipe rank."""
    def encoder_apply(vit, x, token_mask=None, pos_embed_override=None):
        return pp_vit_apply(vit, x, mesh, n_micro, all_layers=False, token_mask=token_mask,
                            pos_embed_override=pos_embed_override)

    return maskformer_apply_fn(encoder_apply)
