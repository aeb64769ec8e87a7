"""Sequence (context) parallelism: ring attention over the ViT token axis
on a ``(data, seq)`` mesh (twin of ``sod_tpu/parallel/sp.py``).

Every seq rank computes the tokens, pads them to a multiple of the ring
(the pads leave every softmax through the key mask), and runs the blocks on
its slice of ``T / S`` tokens: LayerNorm, the projections and the MLP are
per-token maps; attention takes this slice's queries against every key,
the key and value slices going round the ring (``ring_attention``: ``S - 1``
``ppermute``s, an f32 online softmax with ``-1e30`` on masked keys).  The
final LayerNormed slices are gathered on every rank and the pads dropped;
the decoder, heads and loss then run alike on every seq rank.

The weights are whole on every rank.  Each rank's gradient of an encoder
leaf is the part its token slice contributes, so the Trainer's layout sums
those over ``seq`` (``StateLayout(partial={"seq": ("encoder.",)})``); the
decoder's are alike on every rank.  Plain PyTorch path only
(``assert_sp_compatible``, ``sp_vit_apply``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sod_tpu_torch.models.vit import prepare_tokens
from sod_tpu_torch.parallel.comm import exchange, gather_along, ppermute
from sod_tpu_torch.parallel.mesh import assert_xla_path, axis_rank, axis_size, make_mesh_nd
from sod_tpu_torch.parallel.tp import block_apply, maskformer_apply_fn, require_plain_blocks

# the encoder's gradients are parts under a seq axis (StateLayout's partial)
SEQ_PARTIAL = {"seq": ("encoder.",)}


def make_mesh_sp(n_data: Optional[int] = None, n_seq: int = 1, device="cuda"):
    """A ``(data, seq)`` mesh.  ``n_data=None`` takes the ranks left after
    the seq axis; ``sod_tpu``'s ``ValueError``s before any rendezvous."""
    return make_mesh_nd(n_data, (n_seq,), ("seq",), device, "n_seq")


def assert_sp_compatible(cfg, mesh) -> None:
    """Fail loudly on configs the ring-attention path does not cover
    (``sod_tpu``'s check and message)."""
    if axis_size(mesh, "seq") <= 1:
        return
    assert_xla_path(
        cfg,
        f"sequence parallelism (seq axis {axis_size(mesh, 'seq')}) requires "
        "the XLA path",
        "the ring stage program is validated on XLA ops only "
        "(see parallel/sp.py docstring)")


def absorb(q, m, l, acc, k, v, key_mask, scale: float):
    """One key/value slice into the online softmax of ``q`` [B, H, C, hd]
    (f32): the running max ``m``, denominator ``l`` and numerator ``acc``
    updated by the slice's logits, ``-1e30`` on its False keys."""
    logits = torch.matmul(q, k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~key_mask[:, None, None, :], -1e30)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor, scale: float, group) -> torch.Tensor:
    """Online-softmax attention of this rank's queries against the whole
    ring.  ``q/k/v``: this rank's token slice [B, H, C, hd]; ``key_mask``:
    its [B, C] bool slice.  The key/value/mask slices go ``S - 1`` times
    round ``group``'s ring (``ppermute``; its backward sends the gradients
    back the other way); f32 throughout, ``sod_tpu``'s recurrence.  Returns
    [B, H, C, hd] in q's dtype."""
    n = 1 if group is None else dist.get_world_size(group)
    b, h, c, hd = q.shape
    qf = q.float()
    m = torch.full((b, h, c), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, c), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, c, hd), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv, mask = torch.stack([k, v]), key_mask
    for i in range(n):
        m, l, acc = absorb(qf, m, l, acc, kv[0], kv[1], mask, scale)
        if i < n - 1:                   # the rotation after the last slice is never read
            kv = ppermute(kv, group, perm)
            mask = exchange(mask.to(torch.uint8), group, perm).bool()
    return (acc / l[..., None]).to(q.dtype)


def _ring_blocks(vit, tokens: torch.Tensor, mask: torch.Tensor, mesh,
                 all_layers: bool = False, model_group=None) -> torch.Tensor:
    """Run the block stack on this rank's token slice (``tokens`` [B, T_pad,
    D] with T_pad a multiple of the ring, ``mask`` [B, T_pad]).  Returns the
    final-LayerNormed tokens [B, T_pad, D], or with ``all_layers`` every
    layer's [L, B, T_pad, D], gathered on every seq rank.

    :param model_group: run each block over this rank's heads, Megatron
        over this group (``parallel/sptp.py``)."""
    cfg = vit.cfg
    n_seq, j = axis_size(mesh, "seq"), axis_rank(mesh, "seq")
    group = mesh.get_group("seq")
    c = tokens.shape[1] // n_seq
    x, km = tokens.narrow(1, j * c, c), mask.narrow(1, j * c, c)

    def attend(q, k, v, scale, key_mask):
        return ring_attention(q, k, v, key_mask, scale, group)

    per_layer = []
    for blk in vit.blocks:
        x = block_apply(blk, x, cfg, km, model_group, attend)
        if all_layers:
            per_layer.append(vit.norm(x))
    out = torch.stack(per_layer) if all_layers else vit.norm(x)
    return gather_along(out, out.dim() - 2, group)


def ring_tokens(vit, x: torch.Tensor, mesh, token_mask=None, pos_embed_override=None):
    """The tokens padded to a multiple of the ring and their key mask (pads
    False): ([B, T_pad, D], [B, T_pad], T)."""
    n_seq = axis_size(mesh, "seq")
    b = x.shape[0]
    tokens, _ = prepare_tokens(vit, x, pos_embed_override)
    t = tokens.shape[1]
    mask = (torch.ones((b, t), dtype=torch.bool, device=tokens.device) if token_mask is None
            else token_mask.to(torch.bool))
    t_pad = -(-t // n_seq) * n_seq
    if t_pad > t:
        tokens = F.pad(tokens, (0, 0, 0, t_pad - t))
        mask = F.pad(mask, (0, t_pad - t))                 # pads: False
    return tokens, mask, t


def sp_vit_apply(vit, x: torch.Tensor, mesh, all_layers: bool = True,
                 token_mask: Optional[torch.Tensor] = None,
                 pos_embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vit_apply`` with the token axis sharded over ``mesh``'s seq axis
    (ring attention; pads to a ring multiple and masks the pads); the
    unfused ``vit_apply``'s math up to the online softmax's order."""
    require_plain_blocks(vit.cfg, "sp_vit_apply", "sp")
    tokens, mask, t = ring_tokens(vit, x, mesh, token_mask, pos_embed_override)
    stack = _ring_blocks(vit, tokens, mask, mesh, all_layers=all_layers)
    return stack[..., :t, :]                               # drop the ring's pads


def make_sp_apply(mesh) -> Callable:
    """A ``MaskFormer`` forward ``apply_fn(model, x, train=False)`` whose ViT
    encoder runs token-sharded over ``mesh`` (``make_train_step(apply_fn=...)``),
    and its canvas hook ``encoder_apply`` for the Evaluator."""
    def encoder_apply(vit, x, token_mask=None, pos_embed_override=None):
        return sp_vit_apply(vit, x, mesh, all_layers=False, token_mask=token_mask,
                            pos_embed_override=pos_embed_override)

    return maskformer_apply_fn(encoder_apply)
