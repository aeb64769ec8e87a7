"""The pseudo-mask backbones of the port against ``sod_tpu`` on the CPU, with
the same weights (``sod_tpu``'s trees through ``models/convert.py``).

* ``models/resnet.py``: ResNet-50 at dilate_scale 8 and ResNet-18 (basic
  blocks, one case with the deep-base stem) at 16 and None, 64 px, res2..res5
  within 1e-4 of the largest magnitude (f32); BN statistics not at the
  identity; ``batch_norm_train`` outputs and updated statistics and
  ``merge_bn_stats``; ``max_pool_3x3_s2`` at odd sizes.
* ``models/deit.py``: a narrow distilled DeiT, features and logits within
  1e-4, the pos-embed resized to another grid.
* ``models/convert.py``: the state-dict bridges, ``_strip_resnet_prefix``,
  ``convert_resnet50`` and ``convert_vit``'s key checks.
* ``models/factory.py``: ``get_model`` for each arch, and a checkpoint read
  back.
* ``data/custom.py``, ``ops/resize.py``'s ``interpolate_nearest`` and
  ``resize_shorter_edge``: equal to ``sod_tpu``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sod_tpu.data.custom import CustomDataset as JaxCustomDataset
from sod_tpu.models import deit as jax_deit
from sod_tpu.models import resnet as jax_resnet
from sod_tpu.models.convert import _strip_resnet_prefix as jax_strip
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.ops.resize import interpolate_nearest as jax_nearest
from sod_tpu.ops.resize import resize_shorter_edge as jax_shorter_edge
from sod_tpu_torch.data.custom import CustomDataset
from sod_tpu_torch.models import convert, deit, resnet
from sod_tpu_torch.models.factory import get_model
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops.resize import interpolate_nearest, resize_shorter_edge

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb_bn(tree, rng):
    """BN parameters and statistics away from the identity, in place."""
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            c = np.asarray(v["scale"]).shape
            tree[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.1, c).astype(np.float32),
                       "mean": rng.normal(0, 0.1, c).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        elif isinstance(v, dict):
            _perturb_bn(v, rng)
    return tree


def _pair(arch, seed, deep_base=False):
    params = jax.device_get(jax_resnet.resnet_init(jax.random.key(seed), arch,
                                                   deep_base=deep_base))
    params = _perturb_bn(params, np.random.default_rng(seed))
    model = resnet.resnet_init(arch, deep_base=deep_base)
    model.load_state_dict({k: _t(v) for k, v in
                           convert.resnet_state_dict_from_jax(params).items()})
    return params, model


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape and err <= TOL, err


@pytest.mark.parametrize("arch,dilate,deep_base", [
    ("resnet50", 8, False), ("resnet18", 16, False), ("resnet18", None, False),
    ("resnet18", 8, True)])
def test_resnet_features_match_sod_tpu(arch, dilate, deep_base):
    params, model = _pair(arch, 1, deep_base)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    block = "bottleneck" if arch == "resnet50" else "basic"
    ref = jax.jit(lambda p, v: jax_resnet.resnet_apply(p, v, dilate, block))(params, x)
    with torch.no_grad():
        got = resnet.resnet_apply(model, _t(x), dilate)
    for k in ("res2", "res3", "res4", "res5"):
        _close(got[k], ref[k])
    if arch == "resnet50":
        assert got["res5"].shape[-1] == resnet.RESNET50_OUT_CHANNELS
        assert got["res5"].shape[1:3] == (8, 8)          # stride 8


def test_batch_norm_train_and_merge_match_sod_tpu():
    params, model = _pair("resnet18", 2)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    stats_j = {}
    ref = jax_resnet.resnet_apply(params, jnp.asarray(x), 8, "basic", train=True,
                                  momentum=0.1, stats=stats_j)
    stats_p = {}
    got = resnet.resnet_apply(model, _t(x), 8, train=True, momentum=0.1, stats=stats_p)
    _close(got["res5"], ref["res5"])
    merged = convert.resnet_state_dict_from_jax(
        jax_resnet.merge_bn_stats(params, jax.device_get(stats_j)))
    resnet.merge_bn_stats(model, stats_p)
    sd = model.state_dict()
    assert len(stats_p) == 20                            # every BN of a ResNet-18
    for k, v in merged.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
    # one layer alone: y and the new statistics
    bn = resnet.BatchNorm(3)
    bn.weight.data.uniform_(0.5, 1.5)
    h = x.transpose(0, 3, 1, 2)
    y, new = resnet.batch_norm_train(bn, _t(h), momentum=0.2)
    p = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy(),
         "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    y_j, new_j = jax_resnet.batch_norm_train(p, jnp.asarray(x), momentum=0.2)
    _close(y.permute(0, 2, 3, 1), y_j)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(new_j[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", [7, 9, 15, 16])
def test_max_pool_matches_sod_tpu(side):
    x = np.random.default_rng(side).standard_normal((2, side, side + 2, 3)).astype(np.float32)
    got = resnet.max_pool_3x3_s2(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_resnet.max_pool_3x3_s2(x)))


def test_deit_matches_sod_tpu():
    jcfg = jax_deit.DeiTConfig(vit=JaxViTConfig(patch_size=8, embed_dim=64, depth=2, n_heads=2,
                                                pos_grid=4), num_classes=10)
    params = jax.device_get(jax_deit.deit_init(jax.random.key(5), jcfg))
    model = deit.DistilledVisionTransformer(deit.DeiTConfig(
        vit=ViTConfig(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4),
        num_classes=10))
    model.load_state_dict({k: _t(v) for k, v in convert.deit_state_dict_from_jax(params).items()})
    for side in (32, 48):                       # the table's grid, then a resized one
        x = np.random.default_rng(side).standard_normal((2, side, side, 3)).astype(np.float32)
        with torch.no_grad():
            _close(deit.deit_forward_features(model, _t(x)),
                   jax_deit.deit_forward_features(params, x, jcfg))
            _close(deit.deit_apply(model, _t(x)), jax_deit.deit_apply(params, x, jcfg))
    cfg = deit.deit_small_distilled_patch16_224()
    assert (cfg.vit.patch_size, cfg.vit.embed_dim, cfg.vit.pos_grid, cfg.num_classes) == (
        16, 384, 14, 1000)


def test_resnet_checkpoint_keys():
    params = jax.device_get(jax_resnet.resnet50_init(jax.random.key(0)))
    sd = convert.resnet_state_dict_from_jax(params)
    wrapped = {f"module.encoder_q.{k}": v for k, v in sd.items()}
    wrapped["module.encoder_q.fc.0.weight"] = np.zeros(3)
    wrapped["module.encoder_q.bn1.num_batches_tracked"] = np.zeros(())
    stripped = convert._strip_resnet_prefix(wrapped)
    assert stripped.keys() == jax_strip(wrapped).keys() == sd.keys()
    model = resnet.resnet50_init()
    assert set(convert.convert_resnet50(wrapped)) == set(model.state_dict())
    del wrapped["module.encoder_q.layer2.0.downsample.1.running_var"]
    with pytest.raises(KeyError, match="downsample"):
        convert.convert_resnet50(wrapped)
    vit_sd = {f"student.{k}": v for k, v in get_model("vit_tiny")[1].state_dict().items()}
    assert set(convert.convert_vit(vit_sd, prefix="student.")) == set(
        get_model("vit_tiny")[1].state_dict())
    with pytest.raises(KeyError):
        convert.convert_vit(vit_sd)


def test_get_model_each_arch(tmp_path):
    from sod_tpu_torch.config import Config

    mcfg, mf, _ = get_model("maskformer", configs=Config())
    assert mcfg.n_queries == 20 and sum(p.numel() for p in mf.parameters()) > 20e6
    vcfg, vit, _ = get_model("vit_small", patch_size=8)
    assert (vcfg.patch_size, vcfg.embed_dim) == (8, 384)
    _, dt, _ = get_model("deit_small_distilled")
    assert dt.pos_embed.shape == (1, 198, 384)
    _, r50, apply = get_model("resnet50", training_method="mocov2", seed=3)
    path = tmp_path / "r50.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in r50.state_dict().items()}}, path)
    _, back, _ = get_model("resnet50", checkpoint=str(path))
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 r50.state_dict().values()))
    with pytest.raises(ValueError):
        get_model("vit_small", training_method="deit")
    with pytest.raises(ValueError):
        get_model("alexnet")


def test_custom_dataset_matches_sod_tpu(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(((50, 70), (80, 40))):
        fp = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(fp)
        paths.append(str(fp))
    for kw in (dict(image_size=32, square=True, raw_uint8=True), dict(image_size=32),
               dict()):
        ours, theirs = CustomDataset(paths, **kw), JaxCustomDataset(paths, **kw)
        assert len(ours) == 2
        for i in range(2):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    with pytest.raises(ValueError):
        CustomDataset([])


def test_interpolate_nearest_and_shorter_edge_match_sod_tpu():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 9)).astype(np.float32)
    for oh, ow in ((14, 18), (10, 13), (5, 4), (224, 31)):
        np.testing.assert_array_equal(interpolate_nearest(_t(x), oh, ow).numpy(),
                                      np.asarray(jax_nearest(x, oh, ow)))
    for hw in ((100, 200), (200, 100), (37, 41), (640, 427), (1, 5)):
        for target in (224, 32, 7):
            assert resize_shorter_edge(hw, target) == jax_shorter_edge(hw, target)
