"""The port's assignment solver (``sod_tpu_torch/ops/hungarian.py``) against
``sod_tpu.ops.hungarian`` and ``scipy.optimize.linear_sum_assignment`` on the
same numpy costs: assignments exactly equal (continuous random costs have
one optimum; with ties, the port must pick sod_tpu's), the batched call
equal to a loop of unbatched ones, the total cost equal to sod_tpu's
``assignment_cost``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from sod_tpu.ops import hungarian as jh
from sod_tpu_torch.ops.hungarian import assignment_cost, hungarian


@pytest.mark.parametrize("shape", [(1, 1), (2, 20), (5, 5), (8, 20)])
def test_assignments_equal_sod_tpu_and_scipy(shape):
    r = np.random.default_rng(sum(shape))
    costs = r.standard_normal((12,) + shape).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jh.hungarian))(jnp.asarray(costs)))
    got = hungarian(torch.from_numpy(costs))
    assert got.dtype == torch.int64 and got.shape == (12, shape[0])
    np.testing.assert_array_equal(got.numpy(), ref)
    for c, g in zip(costs, got.numpy()):
        rows, cols = linear_sum_assignment(c)
        np.testing.assert_array_equal(g, cols[np.argsort(rows)])


@pytest.mark.parametrize("shape", [(2, 20), (5, 5), (4, 6)])
def test_ties_pick_sod_tpus_assignment(shape):
    """Costs on a coarse grid tie often; torch.argmin and jnp.argmin both
    take the first minimum, so the paths and the assignment are the same.
    The all-zero matrix is the extreme case."""
    r = np.random.default_rng(7)
    costs = np.round(r.standard_normal((16,) + shape) * 1.5).astype(np.float32)
    costs[0] = 0.0
    ref = np.asarray(jax.jit(jax.vmap(jh.hungarian))(jnp.asarray(costs)))
    got = hungarian(torch.from_numpy(costs)).numpy()
    np.testing.assert_array_equal(got, ref)
    for c, g in zip(costs, got):
        assert len(set(g.tolist())) == shape[0]
        rows, cols = linear_sum_assignment(c)
        assert c[np.arange(shape[0]), g].sum() == c[rows, cols].sum()


def test_padded_rows_do_not_disturb():
    """As tests/test_hungarian.py: real rows first, constant padding rows
    after them; the real rows' assignment is scipy's on the real rows."""
    rng = np.random.RandomState(1)
    cost = rng.rand(2, 8).astype(np.float32)
    padded = np.concatenate([cost, np.full((3, 8), 0.5, np.float32)], axis=0)
    got = hungarian(torch.from_numpy(padded)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.hungarian(jnp.asarray(padded))))
    rows, cols = linear_sum_assignment(cost)
    np.testing.assert_allclose(cost[np.arange(2), got[:2]].sum(), cost[rows, cols].sum(),
                               rtol=1e-6)


def test_batched_equals_a_loop_of_unbatched_calls():
    r = np.random.default_rng(3)
    costs = torch.from_numpy(r.standard_normal((10, 3, 7)).astype(np.float32))
    batched = hungarian(costs)
    loop = torch.stack([hungarian(c) for c in costs])
    assert torch.equal(batched, loop) and loop.shape == (10, 3)
    totals = assignment_cost(costs, batched)
    for c, a, t in zip(costs, batched, totals):
        ref = jh.assignment_cost(jnp.asarray(c.numpy()), jnp.asarray(a.numpy()))
        np.testing.assert_allclose(float(assignment_cost(c, a)), float(ref), rtol=1e-6)
        assert float(t) == float(assignment_cost(c, a))


def test_more_rows_than_columns_raises():
    with pytest.raises(ValueError, match="M <= Q"):
        hungarian(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="M <= Q"):
        jh.hungarian(jnp.zeros((3, 2)))
