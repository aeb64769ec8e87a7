"""The port's host data path against ``sod_tpu.data``, byte for byte: the
RLE codec, the train augmentations from one seeded generator, a DUTS
train sample (float and uint8 shipping), ``collate_train`` and the
loader's batch order, on a tiny synthetic DUTS directory."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from sod_tpu.data import augment as jaug
from sod_tpu.data.duts import DUTSDataset as JaxDUTS
from sod_tpu.data.loader import DataLoader as JaxLoader
from sod_tpu.data.loader import collate_train as jax_collate
from sod_tpu.ops import rle as jax_rle
from sod_tpu_torch.data import augment as taug
from sod_tpu_torch.data.duts import DUTSDataset
from sod_tpu_torch.data.loader import DataLoader, collate_train, stable_label
from sod_tpu_torch.ops import rle


@pytest.fixture(scope="module")
def duts_dir(tmp_path_factory):
    """DUTS-TR images of assorted sizes and a pseudo-mask JSON of 1-2 RLE
    masks each at the train size, one all-zero mask among them."""
    root = str(tmp_path_factory.mktemp("duts"))
    tr = os.path.join(root, "DUTS", "DUTS-TR-Image")
    os.makedirs(tr)
    r = np.random.default_rng(0)
    masks = {}
    for i in range(7):
        h, w = 30 + 7 * i, 50 - 3 * i
        im = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(im).save(os.path.join(tr, f"im_{i}.jpg"))
        stack = np.zeros((32, 32, 1 + i % 2), np.uint8)
        if i != 3:
            stack[4 + i:20, 6:25 - i, 0] = 1
        stack[..., -1][10:30, 2:12] |= np.uint8(i % 2)
        masks[f"im_{i}.jpg"] = rle.encode(stack)
    pm = os.path.join(root, "pm.json")
    with open(pm, "w") as f:
        json.dump(masks, f)
    return os.path.join(root, "DUTS"), pm


def test_rle_round_trip_and_equality():
    r = np.random.default_rng(1)
    for shape in ((17, 23), (1, 9), (32, 32, 3)):
        m = (r.random(shape) > 0.6).astype(np.uint8)
        enc = rle.encode(m)
        assert enc == jax_rle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(rle.decode(enc), jax_rle.decode(enc))
    one = rle.encode(np.eye(5, dtype=np.uint8))
    assert rle.area(one) == jax_rle.area(one) == 5
    assert rle.iou(one, one) == 1.0


def test_augmentations_are_byte_equal():
    r = np.random.default_rng(2)
    img = Image.fromarray(r.integers(0, 256, (37, 52, 3), dtype=np.uint8))
    masks = (r.random((2, 37, 52)) > 0.5).astype(np.uint8)
    for seed in range(4):
        outs = []
        for mod in (jaug, taug):
            g = np.random.default_rng(seed)
            arr, m = mod.geometric_augmentations(g, img, masks, (0.5, 1.5), 32, 0)
            arr = mod.photometric_augmentations(g, arr)
            outs.append((arr, m, mod.normalize(arr),
                         np.asarray(mod.resize_pil(img, (20, 30), "bilinear")),
                         g.random()))     # both drew the same count
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    g1, g2 = np.random.default_rng(9), np.random.default_rng(9)
    x = r.random((20, 24, 3)).astype(np.float32) * 255
    np.testing.assert_array_equal(taug.color_jitter(g1, x), jaug.color_jitter(g2, x))
    np.testing.assert_array_equal(taug.to_grayscale(x), jaug.to_grayscale(x))
    np.testing.assert_array_equal(taug.gaussian_blur(g1, x, 5),
                                  jaug.gaussian_blur(g2, x, 5))


def _datasets(duts_dir, u8):
    root, pm = duts_dir
    out = []
    for cls in (JaxDUTS, DUTSDataset):
        ds = cls(root, img_size=32, pseudo_masks_fp=pm, scale_range=(0.5, 1.2))
        ds.set_mode("train")
        ds.train_u8, ds.seed, ds.epoch = u8, 3, 2
        out.append(ds)
    return out


@pytest.mark.parametrize("u8", [False, True])
def test_duts_samples_and_collate_are_byte_equal(duts_dir, u8):
    jds, tds = _datasets(duts_dir, u8)
    assert len(jds) == len(tds) == 7
    js, ts = [jds[i] for i in range(7)], [tds[i] for i in range(7)]
    for a, b in zip(js, ts):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ja, ta = jax_collate(js[:4], 2, 4), collate_train(ts[:4], 2, 4)
    assert ta["gt_valid"][3].tolist() == [True, False]   # empty row dropped
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    assert ta["labels"][0] == stable_label(ts[0]["filename"])


def test_loader_batch_order_is_sod_tpu_order(duts_dir):
    jds, tds = _datasets(duts_dir, True)
    orders = []
    for ds, cls, coll in ((jds, JaxLoader, jax_collate), (tds, DataLoader, collate_train)):
        loader = cls(ds, batch_size=3, shuffle=True, num_workers=2, seed=5,
                     collate_fn=lambda s, c=coll: c(s, 2, 3))
        loader.set_epoch(4)
        assert len(loader) == 3
        orders.append([(b["filename"], b["image"]) for b in loader])
    for (fa, ia), (fb, ib) in zip(*orders):
        assert fa == fb
        np.testing.assert_array_equal(ia, ib)
