"""K2 in the port (``sod_tpu_torch/ops/flash_attention.py``) against
``sod_tpu``'s flash attention, on the same numpy inputs in bf16.

* The plain forward against the Pallas ``_fwd_kernel`` /
  ``_fwd_kernel_masked`` in interpret mode, and the plain backward against
  the interpret ``_bwd_kernel``: within one bf16 ulp elementwise (both keep
  the same rounding points; only f32 summation order differs).
* The autograd route's gradients against ``jax.grad`` of ``flash_attention``
  (on the CPU its XLA forward and backward): atol and rtol 0.05, the
  ``tests/test_flash_attention.py`` standard.
* The masked backward against ``sod_tpu``'s XLA branch: one bf16 ulp, or
  2^-10 absolute where products of O(1) terms cancel to small values.
* The CUDA wrappers raise on what the kernels do not take.  The kernels
  themselves run only on the card (``chip_smoke.py`` phase 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod_tpu.ops.flash_attention as jax_flash
from sod_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 3, 32
SCALE = D ** -0.5


def _inputs(n, seed=0):
    r = np.random.default_rng(seed + n)
    qkv = [r.standard_normal((B, H, n, D)).astype(np.float32) for _ in range(3)]
    do = (r.standard_normal((B, H, n, D)) * 0.5).astype(np.float32)
    mask = r.random((B, n)) > 0.3
    mask[:, 0] = True                       # at least one valid key per image
    return qkv + [do], mask


def _bf16(arrays):
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _assert_within_bf16_ulp(got, ref, atol=0.0):
    a, b = _f32(got), _f32(ref)
    # one bf16 ulp of the larger magnitude: f32 spacing scaled by 2^16
    ulp = np.maximum(np.spacing(np.abs(a)), np.spacing(np.abs(b))) * 2.0 ** 16
    bad = np.abs(a - b) > np.maximum(ulp, atol)
    assert not bad.any(), (f"{bad.sum()} elements beyond one bf16 ulp, max "
                           f"abs {np.abs(a - b).max()}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [64, 130])
def test_plain_forward_matches_interpret_kernel(n, masked):
    arrays, mask = _inputs(n)
    (qj, kj, vj, _), (qt, kt, vt, _) = _bf16(arrays)
    ref = jax_flash._flash_forward(qj, kj, vj, SCALE,
                                   jnp.asarray(mask) if masked else None,
                                   interpret=True)
    got = fa.flash_forward_reference(qt, kt, vt, SCALE,
                                     torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _assert_within_bf16_ulp(got, ref)


@pytest.mark.parametrize("n", [64, 130])
def test_plain_backward_matches_interpret_kernel(n):
    arrays, _ = _inputs(n)
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _bf16(arrays)
    refs = jax_flash._flash_backward(qj, kj, vj, doj, SCALE, interpret=True)
    gots = fa.flash_backward_reference(qt, kt, vt, dot, SCALE)
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.bfloat16
        _assert_within_bf16_ulp(got, ref)


def _grads_jax(qj, kj, vj, doj, mask):
    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, SCALE, mask)
        return jnp.sum(o.astype(jnp.float32) * doj.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)


def _grads_torch(qt, kt, vt, dot, mask):
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    o = fa.flash_attention(*leaves, SCALE, mask)
    (o.float() * dot.float()).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("n", [17, 130])
def test_autograd_matches_jax_grad(n):
    arrays, _ = _inputs(n, seed=1)
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _bf16(arrays)
    for got, ref in zip(_grads_torch(qt, kt, vt, dot, None),
                        _grads_jax(qj, kj, vj, doj, None)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=0.05, rtol=0.05)


def test_masked_backward_matches_sod_tpu_xla_branch():
    arrays, mask = _inputs(130, seed=2)
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _bf16(arrays)
    refs = _grads_jax(qj, kj, vj, doj, jnp.asarray(mask))
    gots = _grads_torch(qt, kt, vt, dot, torch.from_numpy(mask))
    direct = fa.flash_backward_masked_reference(qt, kt, vt, dot, SCALE,
                                                torch.from_numpy(mask))
    for got, d, ref in zip(gots, direct, refs):
        assert torch.equal(got, d)          # autograd takes the masked branch
        _assert_within_bf16_ulp(got, ref, atol=2.0 ** -10)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    m = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, q[:, :1], q, SCALE)
    with pytest.raises(ValueError, match="key_mask"):
        fa.flash_attention(q, q, q, SCALE, torch.ones(1, 7, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_forward_cuda(q, q, q, SCALE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_backward_cuda(q, q, q, q, m, m, SCALE)
    meta = torch.empty(1, 2, 8, 48, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no flash attention"):
        fa.flash_attention(meta, meta, meta, SCALE)


def test_cpu_route_launches_no_kernel():
    arrays, _ = _inputs(64)
    _, (qt, kt, vt, dot) = _bf16(arrays)
    before = (fa.fwd_launches, fa.bwd_launches)
    _grads_torch(qt, kt, vt, dot, None)
    assert (fa.fwd_launches, fa.bwd_launches) == before
