"""Exact linear sum assignment on the tensors' device (twin of
``sod_tpu/ops/hungarian.py``).

Jonker-Volgenant shortest augmenting paths, batched over a leading problem
axis: ``[P, M, Q]`` costs give ``[P, M]`` assignments in one pass of tensor
ops, with no host synchronisation.  ``sod_tpu`` runs the same algorithm
under ``vmap`` with ``lax.while_loop``; here every loop has a fixed trip
count and a problem that has finished is frozen by ``torch.where`` on its
own flag:

* rows: M, one augmentation each;
* path steps of row i (1-based): at most i.  Each step marks one column
  used, and the path goes on only while the column it reached is matched;
  before row i, i - 1 columns are matched, so the i-th step at the latest
  reaches a free column (M <= Q leaves one);
* augmentation steps of row i: at most i, one per column on the path.

Kept as in ``sod_tpu``: the first minimum on ties (``torch.argmin`` and
``jnp.argmin`` both take it), the row potentials updated by a scatter-add
(``u.at[p].add``: unused columns add zero, several of them to row 0), and
the inversion to ``col4row`` dropping unmatched columns.
"""
from __future__ import annotations

import torch

_INF = 1e30


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Minimum-cost assignment of rows to columns.

    :param cost: [M, Q] or [P, M, Q] float costs, M <= Q.
    :return: int64 ``col4row`` [M] or [P, M]: the column of each row (rows
        in order, as scipy's ``linear_sum_assignment`` gives them)."""
    if cost.dim() == 2:
        return hungarian(cost[None])[0]
    n_prob, m, q = cost.shape
    if m > q:
        raise ValueError(f"hungarian requires M <= Q, got {tuple(cost.shape[-2:])}")
    dev = cost.device
    # 1-based rows (0 = none); column 0 is the virtual start column
    c = torch.zeros(n_prob, m + 1, q + 1, device=dev)
    c[:, 1:, 1:] = cost.float()
    u = torch.zeros(n_prob, m + 1, device=dev)             # row potentials
    v = torch.zeros(n_prob, q + 1, device=dev)             # column potentials
    p = torch.zeros(n_prob, q + 1, dtype=torch.int64, device=dev)  # row of column j
    col_ids = torch.arange(q + 1, device=dev)
    inf = torch.full((n_prob, q + 1), _INF, device=dev)
    start = torch.zeros(n_prob, 1, dtype=torch.int64, device=dev)

    for i in range(1, m + 1):
        minv = inf
        used = torch.zeros(n_prob, q + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(n_prob, q + 1, dtype=torch.int64, device=dev)
        p[:, 0] = i
        j0 = start
        active = torch.ones(n_prob, 1, dtype=torch.bool, device=dev)
        for _ in range(i):
            used_n = used | (col_ids == j0)
            i0 = p.gather(1, j0)                                       # [P, 1]
            row = c.gather(1, i0[:, :, None].expand(-1, 1, q + 1))[:, 0]
            cur = row - u.gather(1, i0) - v
            cur = torch.where(used_n | (col_ids == 0), inf, cur)
            better = cur < minv
            minv_n = torch.where(better, cur, minv)
            way_n = torch.where(better, j0, way)
            masked = torch.where(used_n, inf, minv_n)
            j1 = torch.argmin(masked, dim=1, keepdim=True)
            delta = masked.gather(1, j1)
            u_n = u.scatter_add(1, p, torch.where(used_n, delta, torch.zeros_like(delta)))
            v_n = torch.where(used_n, v - delta, v)
            minv_n = torch.where(used_n, minv_n, minv_n - delta)
            used = torch.where(active, used_n, used)
            minv = torch.where(active, minv_n, minv)
            way = torch.where(active, way_n, way)
            u = torch.where(active, u_n, u)
            v = torch.where(active, v_n, v)
            j0 = torch.where(active, j1, j0)
            active = active & (p.gather(1, j0) != 0)
        # augment along the alternating path back to the virtual column
        for _ in range(i):
            going = j0 != 0
            j1 = way.gather(1, j0)
            p = torch.where(going & (col_ids == j0), p.gather(1, j1), p)
            j0 = torch.where(going, j1, j0)

    # invert: col4row[r] = j - 1 where p[j] == r + 1; unmatched columns go to
    # the slot M, which is dropped
    rows = p[:, 1:]
    idx = torch.where(rows >= 1, rows - 1, torch.full_like(rows, m))
    col4row = torch.full((n_prob, m + 1), -1, dtype=torch.int64, device=dev)
    col4row.scatter_(1, idx, col_ids[1:].expand(n_prob, q) - 1)
    return col4row[:, :m]


def assignment_cost(cost: torch.Tensor, col4row: torch.Tensor) -> torch.Tensor:
    """Total cost of an assignment: [M, Q] and [M] -> a scalar, or
    [P, M, Q] and [P, M] -> [P]."""
    return torch.gather(cost, -1, col4row[..., None]).sum((-1, -2))
