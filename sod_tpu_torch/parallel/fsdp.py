"""ZeRO-1 and FSDP-full state sharding over the ``data`` axis (twin of
``sod_tpu/parallel/fsdp.py``).

Two levels (``Config.fsdp``), as in ``sod_tpu``:

* ``"zero1"``: the weights stay whole on every rank, so every compute path
  runs as it is, the kernels included; the f32 AdamW moments are sharded,
  each rank updating its shard of the weights and all-gathering the result.
* ``"full"``: the weights are stored sharded too.  A step all-gathers them,
  runs forward and backward on the whole weights, reduce-scatters the
  gradients, updates the shards and frees the gathered weights.  Plain
  PyTorch path only (``assert_fsdp_compatible``), as in ``sod_tpu``.

The sharding rule is ``sod_tpu``'s: a leaf shards its largest axis that the
``data`` size divides, and leaves under ``MIN_SHARD_SIZE`` elements stay
whole.  It is applied to each parameter's leaf in ``sod_tpu``'s layout
(``reference_layout``): its linears are (in, out) where the port's are
(out, in), its convolutions HWIO where the port's are OIHW, and its encoder
blocks and decoder layers stacked along a leading layer axis.  So the port
picks the same leaves and the same axis, ties included.  A leaf whose
chosen axis the port cannot shard alone (the layer axis of a stack, or the
patch embedding's flattened (py, px, c) axis) stays whole, as a leaf with no
divisible axis does.

``StateLayout`` is the state of one rank: which tensors the optimizer
steps on (whole parameters, or shards), the one reduction of the gradients
per step (a flat all-reduce of the whole leaves and one reduce-scatter of
the sharded ones), the gather of the updated weights, and the whole state
for checkpoints, on every layout the same.
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from sod_tpu_torch.parallel.mesh import (all_gather_into, assert_xla_path, data_group, data_rank,
                                         data_size, reduce_scatter_into)

# leaves below this many elements stay whole: LayerNorm scales and biases,
# the cls token and the query embeddings
MIN_SHARD_SIZE = 16384

_LEVELS = ("none", "zero1", "full")
_STACKED = re.compile(r"^(encoder\.blocks|decoder\.layers)\.(\d+)\.")


def reference_layout(name: str, shape, depths: Dict[str, int]
                     ) -> Tuple[Tuple[int, ...], List[Optional[int]]]:
    """``sod_tpu``'s leaf for the port's parameter ``name`` of ``shape``:
    (its shape, and for each of its axes the port's axis, or None for the
    layer axis of a stack and for a flattened axis).

    :param depths: {stack prefix: number of layers} of the model."""
    shape = tuple(shape)
    if name.endswith("patch_embed.proj.weight"):        # (p*p*c, D) <- (D, c, p, p)
        ref, axes = (shape[1] * shape[2] * shape[3], shape[0]), [None, 0]
    elif len(shape) == 4:                                # HWIO <- OIHW
        ref, axes = (shape[2], shape[3], shape[1], shape[0]), [2, 3, 1, 0]
    elif len(shape) == 2 and name.endswith("weight"):   # (in, out) <- (out, in)
        ref, axes = (shape[1], shape[0]), [1, 0]
    else:
        ref, axes = shape, list(range(len(shape)))
    m = _STACKED.match(name)
    if m:
        ref, axes = (depths[m.group(1)],) + ref, [None] + axes
    return ref, axes


def _add_data_axis(shape, n: int, min_size: int) -> Optional[int]:
    """``sod_tpu``'s choice: the largest ``n``-divisible axis of a leaf of at
    least ``min_size`` elements (the lowest index among equals), or None."""
    size = 1
    for s in shape:
        size *= s
    if n <= 1 or not shape or size < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % n == 0:
            return d
    return None


def fsdp_specs(model: torch.nn.Module, mesh, min_size: int = MIN_SHARD_SIZE,
               n: Optional[int] = None) -> Dict[str, Optional[int]]:
    """{parameter name: the axis it shards over ``data``, or None for a
    whole leaf} (all None on a 1-rank data axis).

    :param n: the data size to shard for, in place of ``mesh``'s."""
    n = data_size(mesh) if n is None else n
    named = list(model.named_parameters())
    depths: Dict[str, int] = {}
    for name, _ in named:
        m = _STACKED.match(name)
        if m:
            depths[m.group(1)] = max(depths.get(m.group(1), 0), int(m.group(2)) + 1)
    specs = {}
    for name, p in named:
        ref, axes = reference_layout(name, p.shape, depths)
        d = _add_data_axis(ref, n, min_size)
        specs[name] = None if d is None else axes[d]
    return specs


def zero1_moment_shardings(model: torch.nn.Module, mesh,
                           min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """The ZeRO-1 moment layout: on the plain data mesh the weights are
    whole, so each moment shards as ``fsdp_specs`` shards its weight."""
    return fsdp_specs(model, mesh, min_size)


def fsdp_param_shardings(model: torch.nn.Module, mesh,
                         min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """The stored-weight layout of ``"full"`` (``fsdp_specs``)."""
    return fsdp_specs(model, mesh, min_size)


def shard_params_fsdp(model: torch.nn.Module, mesh) -> "StateLayout":
    """Store ``model``'s weights sharded over ``data`` (the ``"full"``
    level); the returned layout holds the shards."""
    return StateLayout(model, mesh, "full")


def assert_fsdp_compatible(cfg, mesh) -> None:
    """Fail loudly on configurations the FSDP path does not cover
    (``sod_tpu``'s checks and messages)."""
    level = getattr(cfg, "fsdp", "none")
    if level not in _LEVELS:
        raise ValueError(f"Config.fsdp must be one of {_LEVELS}, "
                         f"got {level!r}")
    if level == "none":
        return
    if mesh is None or data_size(mesh) <= 1:
        raise ValueError(
            f"fsdp={level!r} needs a data mesh axis > 1 to shard over "
            "(Config.mesh_data_axis / --n_devices)")
    if level == "full":
        assert_xla_path(
            cfg,
            "fsdp='full' stores the weights sharded, which requires "
            "the XLA compute path",
            "Pallas kernels are single-shard programs (zero1 composes "
            "with them; see parallel/fsdp.py)")


class StateLayout:
    """One rank's share of a model's training state under ``level``.

    ``tensors`` are what the optimizer steps on, one per parameter: the
    parameter itself (``"none"``, and whole leaves), a view of this rank's
    shard of it (``"zero1"``), or the stored shard (``"full"``; the
    parameter's own storage is then empty outside ``gathered()``)."""

    def __init__(self, model: torch.nn.Module, mesh, level: str = "none",
                 specs: Optional[Dict[str, Optional[int]]] = None):
        """:param specs: the axis each parameter shards over (``fsdp_specs``
        of ``mesh``, the default).  On a 1-rank mesh ``fsdp_specs(model,
        mesh, n=2)`` sends the leaves that two ranks shard through the
        reduce-scatter and the all-gathers whole: how one card runs those
        collectives."""
        if level not in _LEVELS:
            raise ValueError(f"Config.fsdp must be one of {_LEVELS}, got {level!r}")
        self.model, self.mesh, self.level = model, mesh, level
        self.n, self.rank = data_size(mesh), data_rank(mesh)
        self.group = data_group(mesh) if mesh is not None else None
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if level == "none":
            specs = {}
        elif specs is None:
            specs = fsdp_specs(model, mesh)
        self.axes = [specs.get(n) for n in self.names]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sharded = [i for i, d in enumerate(self.axes) if d is not None]
        self.whole = [i for i, d in enumerate(self.axes) if d is None]
        if level == "full":
            self.tensors = [self._own(p.data, i).clone(memory_format=torch.contiguous_format)
                            if i in self.sharded else p.data
                            for i, p in enumerate(self.params)]
            self.release()
        elif level == "zero1":
            self.tensors = [self._own(p.data, i) if i in self.sharded else p.data
                            for i, p in enumerate(self.params)]
        else:
            self.tensors = list(self.params)

    # -- shards ---------------------------------------------------------
    def _own(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's shard of a whole leaf ``t`` of parameter ``i`` (a view)."""
        d = self.axes[i]
        c = t.shape[d] // self.n
        return t.narrow(d, self.rank * c, c)

    def _pack(self, leaves: List[torch.Tensor], idx: List[int]) -> torch.Tensor:
        """[n * S]: for each rank, its shard of every leaf, flattened in
        order (the layout of one reduce-scatter / all-gather)."""
        parts = [leaf.movedim(self.axes[i], 0).reshape(self.n, -1)
                 for leaf, i in zip(leaves, idx)]
        return torch.cat(parts, dim=1).reshape(-1)

    def _unpack_shards(self, flat: torch.Tensor, idx: List[int]) -> List[torch.Tensor]:
        """This rank's [S] -> each leaf's shard in its own layout."""
        out, o = [], 0
        for i in idx:
            d, shape = self.axes[i], list(self.shapes[i])
            shape[d] //= self.n
            moved = [shape[d]] + shape[:d] + shape[d + 1:]
            size = 1
            for s in moved:
                size *= s
            out.append(flat[o:o + size].reshape(moved).movedim(0, d).contiguous())
            o += size
        return out

    def _gather(self, shards: List[torch.Tensor], idx: List[int]) -> List[torch.Tensor]:
        """The whole leaves from every rank's shards: one all-gather."""
        local = torch.cat([s.movedim(self.axes[i], 0).reshape(-1)
                           for s, i in zip(shards, idx)])
        full = local.new_empty(self.n * local.numel())
        all_gather_into(full, local, group=self.group)
        full = full.reshape(self.n, -1)
        out, o = [], 0
        for s, i in zip(shards, idx):
            d = self.axes[i]
            k = s.numel()
            moved = list(s.movedim(d, 0).shape)
            moved[0] *= self.n
            out.append(full[:, o:o + k].reshape(moved).movedim(0, d))
            o += k
        return out

    # -- the step ---------------------------------------------------------
    def reduce_grads(self) -> List[torch.Tensor]:
        """The parameters' gradients summed over the ranks, one per
        ``tensors`` entry (this rank's shard for a sharded leaf): a flat
        all-reduce of the whole leaves and one reduce-scatter of the sharded
        ones.  The parameters' whole gradients are freed."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        if self.whole:
            flat = torch.cat([grads[i].reshape(-1) for i in self.whole])
            dist.all_reduce(flat, group=self.group)
            o = 0
            for i in self.whole:
                k = grads[i].numel()
                out[i] = flat[o:o + k].view_as(grads[i])
                o += k
        if self.sharded:
            packed = self._pack([grads[i] for i in self.sharded], self.sharded)
            mine = packed.new_empty(packed.numel() // self.n)
            reduce_scatter_into(mine, packed, group=self.group)
            for i, g in zip(self.sharded, self._unpack_shards(mine, self.sharded)):
                out[i] = g
        for p in self.params:
            p.grad = None
        return out

    def grad_norm(self, reduced: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole reduced gradient: each leaf's square
        norm, a shard's summed over the ranks, then all summed in the
        parameters' order, as ``optim.global_norm`` sums them."""
        sq = torch.stack(torch._foreach_norm(reduced, 2)).float().square()
        if self.sharded:
            mask = torch.zeros_like(sq, dtype=torch.bool)
            mask[self.sharded] = True
            shards = sq * mask
            dist.all_reduce(shards, group=self.group)
            sq = torch.where(mask, shards, sq)
        return sq.sum().sqrt()

    @torch.no_grad()
    def publish(self) -> None:
        """After the update: under ``"zero1"`` every rank's updated shards
        gathered into the whole weights; under ``"full"`` the gathered
        weights freed."""
        if self.level == "zero1" and self.sharded:
            whole = self._gather([self.tensors[i] for i in self.sharded], self.sharded)
            for i, w in zip(self.sharded, whole):
                self.params[i].data.copy_(w)
        elif self.level == "full":
            self.release()

    @torch.no_grad()
    def gather(self) -> None:
        """``"full"``: the whole weights into the parameters, from the
        shards (before a forward).  A no-op for the other levels."""
        if self.level != "full" or not self.sharded:
            return
        whole = self._gather([self.tensors[i] for i in self.sharded], self.sharded)
        for i, w in zip(self.sharded, whole):
            self.params[i].data = w.contiguous()

    def release(self) -> None:
        """``"full"``: free the gathered whole weights of sharded leaves."""
        if self.level == "full":
            for i in self.sharded:
                p = self.params[i]
                p.data = p.data.new_empty(0)

    @contextlib.contextmanager
    def gathered(self):
        """The whole weights in the model for the block (collective)."""
        self.gather()
        try:
            yield self.model
        finally:
            self.release()

    # -- checkpoints ---------------------------------------------------------
    @torch.no_grad()
    def full_state(self, optimizer) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """The model's state dict and the optimizer's, whole, on every rank
        (collective): the same files whatever the layout."""
        with self.gathered():
            model_state = {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()}
        opt = optimizer.state_dict()
        if self.level != "none" and self.sharded:
            for key in ("mu", "nu"):
                moments = list(opt[key])
                whole = self._gather([moments[i] for i in self.sharded], self.sharded)
                for i, w in zip(self.sharded, whole):
                    moments[i] = w.contiguous()
                opt[key] = moments
        return model_state, opt

    @torch.no_grad()
    def load_full_state(self, model_state: Dict[str, torch.Tensor], optimizer,
                        opt_state: Optional[Dict] = None) -> None:
        """Restore a whole state (``full_state``'s, or a checkpoint written
        under any layout) into this rank's share."""
        if self.level == "full":
            for i in self.sharded:
                self.params[i].data = self.params[i].data.new_empty(self.shapes[i])
        self.model.load_state_dict(model_state)
        if self.level == "full":
            for i in self.sharded:
                self.tensors[i].copy_(self._own(self.params[i].data, i))
            self.release()
        if opt_state is not None:
            if self.level != "none" and self.sharded:
                opt_state = dict(opt_state)
                for key in ("mu", "nu"):
                    moments = list(opt_state[key])
                    for i in self.sharded:
                        if tuple(moments[i].shape) == self.shapes[i]:
                            moments[i] = self._own(moments[i], i)
                    opt_state[key] = moments
            optimizer.load_state_dict(opt_state)

    def bytes_per_rank(self, optimizer) -> Dict[str, int]:
        """Bytes this rank stores of the weights, the two moments and the
        parameters' gradients."""
        def size(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        weights = size(p.data for p in self.params)
        if self.level == "full":
            weights += size(self.tensors[i] for i in self.sharded)
        return {"weights": weights, "moments": size(optimizer.mu + optimizer.nu),
                "grads": size(p.grad for p in self.params if p.grad is not None)}
