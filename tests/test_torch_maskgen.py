"""Pseudo-mask generation of the port against ``sod_tpu``, on the CPU.

* ``utils/jax_prng.py``: ``randint`` equal to ``jax.random.randint`` and the
  uniforms under ``jax.random.normal`` equal to jax's over a grid of seeds
  and sizes; the normals within 4 f32 ulps (XLA's CPU ``log1p`` is its own
  polynomial, see the module docstring).
* ``data/clusterings.py``: ``kmeans`` labels equal to ``sod_tpu``'s; the
  dense-eigh ``spectral_cluster_multi`` labels (N <= 512) equal; on the
  subspace path (N 600) the partition agrees on >= 0.99 of the nodes up to a
  permutation of labels.
* ``data/mask_generator.py``: ``MaskGenerator`` on three tiny images (patch
  8, image 32: 64 nodes, the dense path) with both packages given the same
  weights writes a byte-identical RLE JSON, k-means and spectral, the ViT
  and the ResNet-50 backbones; ``vote_mask`` and the label upsample.
* ``cli/generate_masks.py``: the reference command line parses, runs on the
  CPU with ``--device cpu``, and ``--n_devices 2`` is refused.
* ``train/evaluator.salient_mask_index`` equal to ``sod_tpu``'s.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sod_tpu.data import clusterings as jax_cl
from sod_tpu.data.mask_generator import MaskGenerator as JaxMaskGenerator
from sod_tpu.data.mask_generator import vote_mask as jax_vote_mask
from sod_tpu.models.resnet import resnet50_init as jax_resnet50_init
from sod_tpu.models.vit import vit_init, vit_small as jax_vit_small
from sod_tpu.train.evaluator import salient_mask_index as jax_salient_mask_index
from sod_tpu_torch.cli import generate_masks as cli
from sod_tpu_torch.data import clusterings
from sod_tpu_torch.data.mask_generator import MaskGenerator, vote_mask
from sod_tpu_torch.models.convert import resnet_state_dict_from_jax, vit_state_dict_from_jax
from sod_tpu_torch.ops import rle
from sod_tpu_torch.train.evaluator import salient_mask_index
from sod_tpu_torch.utils import jax_prng


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- the PRNG twin

@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2 ** 31 - 1, 2 ** 40 + 5])
def test_randint_equals_jax(seed):
    for n in (1, 2, 3, 64, 600, 784, 3136, 10 ** 6 + 3):
        assert jax_prng.randint(seed, n) == int(
            jax.random.randint(jax.random.key(seed), (), 0, n)), (seed, n)


@pytest.mark.parametrize("shape", [(64, 6), (600, 5), (784, 6), (3136, 6), (7,)])
def test_normal_draw_matches_jax(shape):
    for seed in (0, 3):
        lo = np.nextafter(np.float32(-1), np.float32(0))
        u = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=1.0))
        np.testing.assert_array_equal(jax_prng.uniform_pm1(seed, shape), u)
        got = jax_prng.normal(seed, shape)
        ref = np.asarray(jax.random.normal(jax.random.key(seed), shape))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
        assert got.dtype == np.float32 and ulps.max() <= 4


# --------------------------------------------------------------- clustering

def _segment_features(seed, grid, d, n_segments=3, noise=0.4):
    """[grid * grid, d] patch-like features: a latent direction per segment,
    a smooth drift and noise (``tests/test_clusterings_parity.py``'s kind)."""
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    cy, cx = r.randint(0, grid, n_segments), r.randint(0, grid, n_segments)
    seg = np.argmin((yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2, axis=-1)
    feats = r.randn(n_segments, d)[seg] * 2.0
    feats += np.sin(yy / grid * 3.1)[..., None] * r.randn(d) * 0.5
    feats += r.randn(grid, grid, d) * noise
    return feats.reshape(-1, d).astype(np.float32)


def _agreement(a, b, k):
    """Share of nodes with equal labels under the best permutation."""
    return max(np.mean(np.asarray(p)[a] == b) for p in itertools.permutations(range(k)))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kmeans_labels_equal_sod_tpu(k):
    x = _segment_features(k, 12, 8, n_segments=k)
    for seed in (0, 5):
        ref = np.asarray(jax.jit(jax_cl.kmeans, static_argnums=(1, 2))(jnp.asarray(x), k, seed))
        np.testing.assert_array_equal(clusterings.kmeans(_t(x), k, seed=seed).numpy(), ref)
    # a batch clusters each image as alone
    xb = np.stack([x, x[::-1].copy()])
    got = clusterings.kmeans(_t(xb), k, seed=0).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], clusterings.kmeans(_t(xb[i]), k).numpy())


def test_dense_spectral_labels_equal_sod_tpu():
    feats = np.stack([_segment_features(s, 16, 24) for s in (0, 1, 2)])   # N 256
    assert feats.shape[1] <= jax_cl._EIGH_MAX_N
    fn = jax.jit(jax.vmap(lambda f: jax_cl.spectral_cluster_multi(f, (2, 3, 4), seed=0)))
    ref = [np.asarray(r) for r in fn(jnp.asarray(feats))]
    got = clusterings.spectral_cluster_multi(_t(feats), (2, 3, 4), seed=0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    single = clusterings.spectral_cluster(_t(feats[0]), 3)
    np.testing.assert_array_equal(single.numpy(), ref[1][0])


def test_subspace_spectral_agrees_with_sod_tpu():
    """N 600 > 512: the subspace path in both packages (QR there,
    CholeskyQR2 here), labels equal up to a permutation on >= 0.99 of the
    nodes, and the port's subspace labels against its own dense oracle."""
    x = np.concatenate([_segment_features(3, 20, 16), _segment_features(4, 20, 16)[:200]])
    assert x.shape[0] == 600 > jax_cl._EIGH_MAX_N
    ks = (2, 3, 4)
    ref = jax.jit(lambda f: jax_cl.spectral_cluster_multi(f, ks, seed=0))(jnp.asarray(x))
    got = clusterings.spectral_cluster_multi(_t(x), ks, seed=0)
    dense = clusterings.spectral_cluster_multi(_t(x), ks, seed=0, eigh_max_n=600)
    for k, g, r, d in zip(ks, got, ref, dense):
        assert _agreement(g.numpy(), np.asarray(r), k) >= 0.99, k
        assert _agreement(g.numpy(), d.numpy(), k) >= 0.99, k


def test_cluster_classes_and_crossover():
    x = _segment_features(9, 8, 8)
    assert clusterings._EIGH_MAX_N == 512
    np.testing.assert_array_equal(clusterings.KMeansClustering()(x, 3).numpy(),
                                  np.asarray(jax_cl.KMeansClustering()(x, 3)))
    np.testing.assert_array_equal(clusterings.SpectralClustering()(x, 2).numpy(),
                                  np.asarray(jax_cl.SpectralClustering()(x, 2)))


# --------------------------------------------------------------- the generator

def _images(tmp_path, n=3, seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        img = np.full((64, 80, 3), 30, np.uint8)
        img[16:48, 20:60] = 220
        img += rng.randint(0, 10, img.shape).astype(np.uint8)
        fp = tmp_path / f"img_{i}.jpg"
        Image.fromarray(img).save(fp)
        paths.append(str(fp))
    return paths


@pytest.mark.parametrize("cluster_type,feature_types", [
    ("k-means", ("dino",)), ("spectral", ("dino",)), ("spectral", ("mocov2", "dino"))])
def test_mask_generator_rle_json_byte_identical(tmp_path, cluster_type, feature_types):
    paths = _images(tmp_path)
    jax_params, port_params = {}, {}
    for ft in feature_types:
        if ft == "dino":
            p = jax.device_get(vit_init(jax.random.key(3), jax_vit_small(patch_size=8)))
            port_params[ft] = {k: _t(v) for k, v in vit_state_dict_from_jax(p).items()}
        else:
            p = jax.device_get(jax_resnet50_init(jax.random.key(4)))
            port_params[ft] = {k: _t(v) for k, v in resnet_state_dict_from_jax(p).items()}
        jax_params[ft] = p
    kw = dict(cluster_sizes=[2, 3], cluster_type=cluster_type, feature_types=list(feature_types),
              patch_size=8, image_size=32, scale_factor=2, batch_size=2, seed=0)
    ref = JaxMaskGenerator(**kw, params=jax_params)(paths)
    gen = MaskGenerator(**kw, params=port_params, device="cpu")
    got = gen(paths)
    assert json.dumps(got) == json.dumps(ref)
    for enc in got.values():
        mask = rle.decode(enc)
        assert mask.shape == (32, 32) and 0 < mask.sum() < 32 * 32
    stacks = gen.extract_candidate_masks(paths)
    assert list(stacks) == paths and stacks[paths[0]].shape == (5 * len(feature_types), 32, 32)


def test_mask_generator_defaults_and_refusals():
    gen = MaskGenerator()
    assert gen.device.type == "cuda"          # the card unless asked
    assert (gen.cluster_sizes, gen.feature_types) == ([2, 3, 4], ["mocov2", "swav", "dino"])
    with pytest.raises(NotImplementedError, match="item 12"):
        MaskGenerator(mesh=object())
    with pytest.raises(ValueError):
        MaskGenerator(cluster_type="dbscan")


def test_vote_and_label_upsample_match_sod_tpu():
    r = np.random.RandomState(1)
    for _ in range(4):
        stack = (r.rand(9, 16, 16) > 0.6).astype(np.uint8)
        assert vote_mask(stack) == jax_vote_mask(stack)
    gen = MaskGenerator(image_size=30, device="cpu")
    ref = JaxMaskGenerator(image_size=30)
    for g in (15, 7):                         # an integer and a fractional factor
        lab = r.randint(0, 4, (g, g)).astype(np.int32)
        np.testing.assert_array_equal(gen._upsample_labels(lab), ref._upsample_labels(lab))


def test_salient_mask_index_equals_sod_tpu():
    r = np.random.RandomState(2)
    for _ in range(5):
        masks = r.rand(6, 24, 24).astype(np.float32)
        masks[:3, 4:18, 5:20] += 0.5
        assert salient_mask_index(masks) == jax_salient_mask_index(masks)
        assert salient_mask_index(masks, 20, 22) == jax_salient_mask_index(masks, 20, 22)


# --------------------------------------------------------------- the CLI

def test_cli_reference_line_parses_and_n_devices_is_refused():
    args = cli.build_argparser().parse_args(
        ["--p_images", "a/*.jpg", "--fp", "out.json", "--use_gpu", "True", "--gpu_id", "0"])
    assert args.device == "cuda" and args.feature_types == ["mocov2", "swav", "dino"]
    assert (args.cluster_type, args.cluster_sizes, args.batch_size) == ("spectral", [2, 3, 4], 16)
    with pytest.raises(NotImplementedError, match="item 12"):
        cli.main(["--p_images", "a.jpg", "--n_devices", "2"])


def test_cli_writes_masks_on_the_cpu(tmp_path):
    paths = _images(tmp_path, n=2)
    out = tmp_path / "out.json"
    masks = cli.main(["--p_images", str(tmp_path / "*.jpg"), "--fp", str(out), "--device", "cpu",
                      "--feature_types", "dino", "--image_size", "64", "--batch_size", "2"])
    assert json.loads(out.read_text()) == masks
    assert sorted(masks) == sorted(p.rsplit("/", 1)[1] for p in paths)
    assert all(rle.decode(m).shape == (64, 64) for m in masks.values())
