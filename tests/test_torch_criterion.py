"""The port's criterion (``sod_tpu_torch/losses/criterion.py``) against
``sod_tpu.losses.criterion`` on the same numpy batch, in f32: losses and
diagnostics <= 1e-5, and the gradients with respect to ``mask_pred``,
``objectness`` and ``features`` against ``jax.grad`` <= 1e-5.  The batch
has an image with no valid GT row, padded GT rows, repeated labels (so the
InfoNCE term has positives) and GT at 4x the prediction resolution."""
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


def _run_jax(bt, objectness=True):
    return jc.criterion_forward(
        jnp.asarray(bt["mask_pred"]), jnp.asarray(bt["gt_masks"]),
        jnp.asarray(bt["gt_valid"]),
        jnp.asarray(bt["objectness"]) if objectness else None, False,
        jnp.asarray(bt["features"]), jnp.asarray(bt["labels"]),
        weight_contrastive_loss=0.1, temperature=0.07)


def _run_torch(bt, objectness=True):
    return tc.criterion_forward(
        torch.from_numpy(bt["mask_pred"]), torch.from_numpy(bt["gt_masks"]),
        torch.from_numpy(bt["gt_valid"]),
        torch.from_numpy(bt["objectness"]) if objectness else None, False,
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


def test_gradients_match_jax_grad():
    bt = _batch(seed=1)

    def jloss(mp, obj, feat):
        return jc.criterion_forward(
            mp, jnp.asarray(bt["gt_masks"]), jnp.asarray(bt["gt_valid"]), obj,
            False, feat, jnp.asarray(bt["labels"]))["loss"]

    refs = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(bt["mask_pred"]), jnp.asarray(bt["objectness"]),
        jnp.asarray(bt["features"]))
    leaves = [torch.from_numpy(bt[k]).requires_grad_()
              for k in ("mask_pred", "objectness", "features")]
    tc.criterion_forward(leaves[0], torch.from_numpy(bt["gt_masks"]),
                         torch.from_numpy(bt["gt_valid"]), leaves[1], False,
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
    bt = _batch()
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        tc.criterion_forward(torch.from_numpy(bt["mask_pred"]),
                             torch.from_numpy(bt["gt_masks"]),
                             torch.from_numpy(bt["gt_valid"]),
                             torch.from_numpy(bt["objectness"]), True)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("sizes", [(56, 224), (7, 13), (20, 20), (224, 56)])
def test_resize_matrix_equals_sod_tpu(mode, sizes):
    """The dense interpolation matrices behind the adjoint GT downsample."""
    np.testing.assert_array_equal(_resize_matrix(*sizes, mode),
                                  jax_resize_matrix(*sizes, mode))
