"""The data-parallel process mesh of the port (twin of
``sod_tpu/parallel/mesh.py``).

``sod_tpu`` is one controller over many devices: a 1-D ``Mesh`` with the
batch axis sharded over ``data`` and GSPMD inserting the reductions.  Here
each device is driven by a process of its own (a rank), the torch idiom:

* ``make_mesh(n, device)`` starts or joins the process group and returns a
  ``DeviceMesh`` with ``mesh_dim_names=("data",)``.  On the card the
  backend is NCCL with rank r on ``cuda:r``; on the CPU it is gloo.  There
  is no fallback from one to the other.  Rendezvous is over ``127.0.0.1``.
* ``spawn_ranks(fn, n, ...)`` starts the n rank processes with the
  ``spawn`` start method (CUDA forbids ``fork``); ``make_mesh`` in each of
  them joins the group they share.
* ``batch_sharding`` / ``shard_batch``: this rank's rows of a global batch,
  the contiguous block that ``P("data")`` puts on device r.  With gradient
  accumulation each rank holds its block of every micro-batch, so that a
  micro-batch is the same rows as in ``sod_tpu``.
* ``replicated``: parameters and buffers broadcast from rank 0.
* ``gather_rows`` / ``all_reduce_sum``: the collectives of the loss and of
  train-mode BatchNorm, differentiable.  ``gather_rows``' backward hands
  each rank the gradient of its own rows: a term computed from the gathered
  rows is computed alike on every rank and counted once by the gradient
  reduction.  ``all_reduce_sum``'s backward is the all-reduce of the
  gradients, since every rank's loss reads the sum.
* ``batch_over(mesh)``: the mesh whose batch a forward runs on, read by
  train-mode BatchNorm (``models/resnet.py``) for its global statistics.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import socket
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# every flag that routes compute through a single-shard kernel, one list so
# that every mesh guard picks a new one up
PALLAS_FLAGS = ("use_pallas_attention", "use_fused_train",
                "use_fused_mlp", "use_fused_eval")

# newer torch releases name them *_single and deprecate the older names
all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_into = (getattr(dist, "reduce_scatter_single", None)
                       or dist.reduce_scatter_tensor)

_BATCH_MESH: contextvars.ContextVar = contextvars.ContextVar("sod_batch_mesh",
                                                             default=None)


def assert_xla_path(cfg, requires: str, why: str) -> None:
    """Raise when any kernel flag is set (``sod_tpu``'s check and message;
    the "XLA path" is the port's plain PyTorch path)."""
    bad = [f for f in PALLAS_FLAGS if getattr(cfg, f, False)]
    if bad:
        raise ValueError(f"{requires}: disable {bad} — {why}")


def device_limit(device_type: str) -> int:
    """How many ranks a mesh on ``device_type`` may hold: the cards, or the
    host's cores for gloo on the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(n_data: Optional[int] = None, device="cuda"):
    """A 1-D data-parallel mesh of ``n_data`` ranks (default: every rank of
    the running group, else every card) on ``device``'s type.

    In a process that ``spawn_ranks`` started, this joins its group; in any
    other process a mesh of one rank starts a group of its own, and more
    ranks raise.  Raises ``sod_tpu``'s ``ValueError`` when ``n_data``
    exceeds the cards, before any rendezvous."""
    kind = torch.device(device).type
    have = device_limit(kind)
    if n_data is None:
        n_data = (dist.get_world_size() if dist.is_initialized()
                  else int(os.environ.get("WORLD_SIZE", have)))
    if n_data > have:
        raise ValueError(f"requested {n_data} devices, have {have}")
    backend = _backend(kind)
    if not dist.is_initialized():
        if "SOD_RANK" in os.environ:
            rank, world = int(os.environ["SOD_RANK"]), int(os.environ["WORLD_SIZE"])
            init = f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}"
        elif n_data == 1:
            rank, world, init = 0, 1, f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError(
                f"make_mesh({n_data}) needs {n_data} rank processes: start them "
                "with spawn_ranks (the CLIs' --n_devices)")
        if kind == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    if dist.get_backend() != backend:
        raise ValueError(f"a mesh on {kind} runs over {backend}, and the process "
                         f"group runs {dist.get_backend()}")
    if dist.get_world_size() != n_data:
        raise ValueError(f"requested {n_data} devices, the process group has "
                         f"{dist.get_world_size()} ranks")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(kind, (n_data,), mesh_dim_names=("data",))


def _rank_main(rank: int, world: int, port: int, fn: Callable, args) -> None:
    os.environ.update(SOD_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_PORT=str(port))
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``n`` new processes (the ``spawn`` start
    method), each able to ``make_mesh(n, ...)``; returns when all have
    ended, and raises if one failed.  ``fn`` must be importable by name."""
    torch.multiprocessing.start_processes(
        _rank_main, args=(n, free_port(), fn, args), nprocs=n, join=True,
        start_method="spawn")


def spawn_cli(fn: Callable, argv, n: int, device: str) -> None:
    """A CLI's ``--n_devices n``: ``sod_tpu``'s ``ValueError`` when
    ``device``'s kind has fewer than ``n``, else ``fn(rank, argv)`` in ``n``
    spawned ranks (``spawn_ranks``), rank r on ``rank_device(device, r)``."""
    have = device_limit(torch.device(device).type)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    spawn_ranks(fn, n, list(argv))


def rank_device(device: str, rank: int) -> str:
    """Rank ``rank``'s device: ``cuda:rank`` on the card, else ``device``."""
    return f"cuda:{rank}" if torch.device(device).type == "cuda" else device


def data_size(mesh) -> int:
    """The ``data`` axis' size (1 without a mesh)."""
    if mesh is None:
        return 1
    names = getattr(mesh, "mesh_dim_names", False)
    if names is False:
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), "
                        f"got {type(mesh).__name__}")
    if "data" not in (names or ()):
        return 1
    return mesh.size(names.index("data"))


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("data")


def data_group(mesh):
    return mesh.get_group("data")


def is_main(mesh) -> bool:
    """Rank 0 of the mesh (or no mesh): the rank that writes files."""
    return data_rank(mesh) == 0


def batch_sharding(mesh, batch_size: int, accum_steps: int = 1,
                   rank: Optional[int] = None) -> np.ndarray:
    """This rank's (or ``rank``'s) rows of a global batch of ``batch_size``:
    the block ``[r * b / n, (r + 1) * b / n)``; with ``accum_steps``
    micro-batches (the global rows ``[k * m, (k + 1) * m)``, as ``sod_tpu``
    splits them) the rank's block of each, in micro-batch order."""
    n = data_size(mesh)
    if batch_size % (n * accum_steps):
        raise ValueError(
            f"batch_size {batch_size} not divisible by the mesh's data axis "
            f"({n}) times the micro-batches ({accum_steps})")
    r = data_rank(mesh) if rank is None else rank
    m = batch_size // accum_steps
    c = m // n
    return np.concatenate([np.arange(k * m + r * c, k * m + (r + 1) * c)
                           for k in range(accum_steps)])


def shard_batch(batch: dict, mesh, accum_steps: int = 1) -> dict:
    """This rank's rows (``batch_sharding``) of every array of a global
    batch dict; lists are indexed alike."""
    b = len(next(iter(batch.values())))
    rows = batch_sharding(mesh, b, accum_steps)
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [v[i] for i in rows]
        elif isinstance(v, torch.Tensor):
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        else:
            out[k] = v[rows]
    return out


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place:
    every rank then starts from the same weights."""
    if mesh is not None:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=dist.get_global_rank(data_group(mesh), 0),
                           group=data_group(mesh))
    return module


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rows, ctx.rank = x.shape[0], rank
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        all_gather_into(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None, None, None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (equal row counts); the
    gradient goes to this rank's own rows."""
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8), data_group(mesh),
                                 data_rank(mesh), data_size(mesh)).bool()
    return _GatherRows.apply(x, data_group(mesh), data_rank(mesh), data_size(mesh))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x, data_group(mesh))


@contextlib.contextmanager
def batch_over(mesh):
    """Mark the forwards inside the block as running on ``mesh``'s rows of
    one global batch (read by ``batch_mesh``)."""
    token = _BATCH_MESH.set(mesh)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def batch_mesh():
    """The mesh of the enclosing ``batch_over`` block, or None."""
    return _BATCH_MESH.get()
