"""The port's criterion (``sod_tpu_torch/losses/criterion.py``) against
``sod_tpu.losses.criterion`` on the same numpy batch, in f32: losses and
diagnostics <= 1e-5, and the gradients with respect to ``mask_pred``,
``objectness`` and ``features`` against ``jax.grad`` <= 1e-5, in the live
branch and in the Hungarian classification branch (its assignments,
``gt_to_query``, exactly).  The batch has an image with no valid GT row,
padded GT rows, repeated labels (so the InfoNCE term has positives) and GT
at 4x the prediction resolution.  Also the pairwise focal and BCE matrices
and the ``Criterion`` dataclass."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.losses import criterion as jc
from sod_tpu.ops.resize import _resize_matrix as jax_resize_matrix
from sod_tpu_torch.losses import criterion as tc
from sod_tpu_torch.ops.resize import _resize_matrix

KEYS = ("loss", "avg_loss", "avg_contrastive_loss", "dice_loss",
        "ranking_loss", "classification_loss", "avg_dice_loss",
        "avg_ranking_loss", "avg_classification_loss", "avg_iou")


def _batch(seed=0, b=4, l=2, q=5, hw=8, m=3, up=4):
    r = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    gt = np.zeros((b, m, hw * up, hw * up), np.float32)
    valid = np.zeros((b, m), bool)
    for i in range(b - 1):                  # the last image has no GT
        for j in range(1 + i % m):
            y, x = r.integers(0, hw * up // 2, 2)
            gt[i, j, y:y + 10 + 3 * j, x:x + 12] = 1.0
            valid[i, j] = True
    return {
        "mask_pred": sig(r.standard_normal((b, l, q, hw, hw)) * 2).astype(np.float32),
        "gt_masks": gt, "gt_valid": valid,
        "objectness": sig(r.standard_normal((b, l, q, 1))).astype(np.float32),
        "features": r.standard_normal((b, 16)).astype(np.float32),
        "labels": np.array([3, 7, 3, 5][:b], np.int32),
    }


def _run_jax(bt, objectness=True, cls=False):
    return jc.criterion_forward(
        jnp.asarray(bt["mask_pred"]), jnp.asarray(bt["gt_masks"]),
        jnp.asarray(bt["gt_valid"]),
        jnp.asarray(bt["objectness"]) if objectness else None, cls,
        jnp.asarray(bt["features"]), jnp.asarray(bt["labels"]),
        weight_contrastive_loss=0.1, temperature=0.07)


def _run_torch(bt, objectness=True, cls=False):
    return tc.criterion_forward(
        torch.from_numpy(bt["mask_pred"]), torch.from_numpy(bt["gt_masks"]),
        torch.from_numpy(bt["gt_valid"]),
        torch.from_numpy(bt["objectness"]) if objectness else None, cls,
        torch.from_numpy(bt["features"]), torch.from_numpy(bt["labels"]),
        weight_contrastive_loss=0.1, temperature=0.07)


@pytest.mark.parametrize("objectness", [True, False])
def test_losses_and_diagnostics_match(objectness):
    bt = _batch()
    ref, got = _run_jax(bt, objectness), _run_torch(bt, objectness)
    for k in KEYS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["gt_to_query"].numpy(),
                                  np.asarray(ref["gt_to_query"]))
    if objectness:
        assert float(ref["ranking_loss"]) > 0 and float(ref["avg_iou"]) >= 0
    assert float(ref["avg_contrastive_loss"]) > 0


@pytest.mark.parametrize("seed,q", [(0, 5), (3, 5), (4, 2), (5, 20)])
def test_classification_branch_matches(seed, q):
    """The Hungarian branch: every key of the dict, the assignments of the
    last layer (``gt_to_query`` [B, 2]) exactly, and ``avg_iou`` of the
    matched foreground query.  q=2 leaves the matcher no spare query."""
    bt = _batch(seed=seed, q=q)
    ref, got = _run_jax(bt, cls=True), _run_torch(bt, cls=True)
    for k in KEYS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert got["gt_to_query"].shape == (4, 2)
    np.testing.assert_array_equal(got["gt_to_query"].numpy(),
                                  np.asarray(ref["gt_to_query"]))
    assert float(ref["classification_loss"]) > 0 and float(ref["ranking_loss"]) == 0
    assert float(ref["dice_loss"]) > 0


def test_gradients_match_jax_grad():
    _check_gradients(cls=False)


def test_classification_branch_gradients_match_jax_grad():
    """The matched dice and -log objectness keep their gradients; the
    assignment is taken on the detached cost."""
    _check_gradients(cls=True)


def _check_gradients(cls):
    bt = _batch(seed=1)

    def jloss(mp, obj, feat):
        return jc.criterion_forward(
            mp, jnp.asarray(bt["gt_masks"]), jnp.asarray(bt["gt_valid"]), obj,
            cls, feat, jnp.asarray(bt["labels"]))["loss"]

    refs = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(bt["mask_pred"]), jnp.asarray(bt["objectness"]),
        jnp.asarray(bt["features"]))
    leaves = [torch.from_numpy(bt[k]).requires_grad_()
              for k in ("mask_pred", "objectness", "features")]
    tc.criterion_forward(leaves[0], torch.from_numpy(bt["gt_masks"]),
                         torch.from_numpy(bt["gt_valid"]), leaves[1], cls,
                         leaves[2], torch.from_numpy(bt["labels"]))["loss"].backward()
    for leaf, ref, name in zip(leaves, refs, ("mask_pred", "objectness", "features")):
        assert np.abs(np.asarray(ref)).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["one_row", "no_positives", "invalid_rows",
                                  "all_valid"])
def test_contrastive_loss_and_its_guards(case):
    r = np.random.default_rng(2)
    feats = r.standard_normal((5, 8)).astype(np.float32)
    labels = np.array([1, 2, 1, 3, 2], np.int32)
    valid = None
    if case == "one_row":
        feats, labels = feats[:1], labels[:1]
    elif case == "no_positives":
        labels = np.arange(5, dtype=np.int32)
    elif case == "invalid_rows":
        valid = np.array([True, False, True, True, False])
    ref = jc.contrastive_loss(jnp.asarray(feats), jnp.asarray(labels), 0.07,
                              None if valid is None else jnp.asarray(valid))
    got = tc.contrastive_loss(torch.from_numpy(feats), torch.from_numpy(labels),
                              0.07, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-5, rtol=1e-5)
    if case in ("one_row", "no_positives"):
        assert float(got) == 0.0


def test_dice_loss_matrix_matches():
    r = np.random.default_rng(3)
    pred = r.random((6, 50)).astype(np.float32)
    gt = (r.random((3, 50)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tc.dice_loss_matrix(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jc.dice_loss_matrix(jnp.asarray(pred), jnp.asarray(gt))),
        atol=1e-6, rtol=0)


def test_classification_branch_is_refused():
    """With one query the two targets cannot be matched: the branch raises
    the matcher's ValueError (M > Q), as sod_tpu's does."""
    bt = _batch(q=1)
    with pytest.raises(ValueError, match="M <= Q"):
        _run_jax(bt, cls=True)
    with pytest.raises(ValueError, match="M <= Q"):
        _run_torch(bt, cls=True)


@pytest.mark.parametrize("fn", ["focal_loss_matrix", "bce_loss_matrix"])
def test_focal_and_bce_matrices_match(fn):
    r = np.random.default_rng(6)
    pred = r.random((6, 50)).astype(np.float32)
    pred[0, :3] = (0.0, 1.0, 1e-9)                 # the clip at eps
    gt = (r.random((3, 50)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        getattr(tc, fn)(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(getattr(jc, fn)(jnp.asarray(pred), jnp.asarray(gt))),
        atol=1e-6, rtol=1e-5)


def test_criterion_dataclass_matches():
    """``Criterion``'s defaults are sod_tpu's, and a configured instance
    gives sod_tpu's losses in both branches."""
    assert tc.Criterion().__dict__ == jc.Criterion().__dict__
    kw = dict(weight_contrastive_loss=0.3, temperature=0.2, weight_rank_loss=0.5,
              weight_focal_loss=1.0)
    bt = _batch(seed=2)
    for cls in (False, True):
        ref = jc.Criterion(**kw)(
            jnp.asarray(bt["mask_pred"]), jnp.asarray(bt["gt_masks"]),
            jnp.asarray(bt["gt_valid"]), jnp.asarray(bt["objectness"]), cls,
            jnp.asarray(bt["features"]), jnp.asarray(bt["labels"]))
        got = tc.Criterion(**kw)(
            torch.from_numpy(bt["mask_pred"]), torch.from_numpy(bt["gt_masks"]),
            torch.from_numpy(bt["gt_valid"]), torch.from_numpy(bt["objectness"]), cls,
            torch.from_numpy(bt["features"]), torch.from_numpy(bt["labels"]))
        for k in KEYS:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("sizes", [(56, 224), (7, 13), (20, 20), (224, 56)])
def test_resize_matrix_equals_sod_tpu(mode, sizes):
    """The dense interpolation matrices behind the adjoint GT downsample."""
    np.testing.assert_array_equal(_resize_matrix(*sizes, mode),
                                  jax_resize_matrix(*sizes, mode))
