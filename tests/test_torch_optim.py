"""The port's schedule and optimizer against ``sod_tpu``'s optax chain.

* ``poly_schedule``: equal to ``sod_tpu``'s (both f32) at every step
  0..3n, with and without the per-epoch wrap, with and without warmup.
* Five updates of ``ClippedAdamW`` against ``optax.chain(
  clip_by_global_norm(1.0), adamw(...))`` built by ``sod_tpu``'s
  ``build_optimizer``, from the same params and gradients: <= 1e-6
  relative on every parameter after every update (f32 rounding of the same
  formulas), once with gradients above the clip norm and once below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.config import Config
from sod_tpu.train.lr_schedule import poly_schedule as jax_poly
from sod_tpu.train.optim import build_optimizer as jax_build
from sod_tpu_torch.train.lr_schedule import poly_schedule
from sod_tpu_torch.train.optim import build_optimizer, global_norm


@pytest.mark.parametrize("warmup,cycle", [(0, None), (0, 7), (7, 7), (4, None)])
def test_schedule_equals_sod_tpu(warmup, cycle):
    n = 7
    kw = dict(base_lr=6e-6, total_iters=3 * n, warmup_iters=warmup,
              cycle_iters=cycle)
    ours, theirs = poly_schedule(**kw), jax_poly(**kw)
    got = np.array([ours(t) for t in range(3 * n + 1)], np.float32)
    ref = np.array([np.float32(theirs(t)) for t in range(3 * n + 1)], np.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("grad_scale,clipped", [(3.0, True), (0.01, False)])
def test_clip_adamw_matches_optax(grad_scale, clipped):
    r = np.random.default_rng(0)
    shapes = {"w": (6, 5), "bias": (5,), "scale": (5,), "emb": (1, 3, 4)}
    params = {k: (r.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in shapes.items()}
    cfg = Config(lr=1e-3, lr_warmup_duration=1, n_epochs=2, weight_decay=0.01)
    n_iters = 3
    tx = jax_build(cfg, n_iters_per_epoch=n_iters)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_optimizer(cfg, list(tp.values()), n_iters_per_epoch=n_iters)

    for _ in range(5):
        grads = {k: (r.standard_normal(s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads.values()))
        assert (norm >= 1.0) == clipped
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                   state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        np.testing.assert_allclose(float(global_norm(opt.grads())), norm, rtol=1e-6)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 5


def test_optimizer_state_round_trip_and_guard():
    p = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))]
    cfg = Config(lr=1e-3, n_epochs=1)
    opt = build_optimizer(cfg, p, n_iters_per_epoch=4)
    for t in p:
        t.grad = torch.full_like(t, 0.1)
    opt.step()
    other = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(3)),
                                  torch.nn.Parameter(torch.zeros(2, 2))], 4)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and all(torch.equal(a, b) for a, b in zip(other.mu, opt.mu))
    wrong = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(4))], 4)
    with pytest.raises(ValueError, match="moments"):
        wrong.load_state_dict(opt.state_dict())
