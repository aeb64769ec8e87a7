"""The port's host data path against ``sod_tpu.data``, byte for byte: the
RLE codec, the train augmentations from one seeded generator, a DUTS
train sample (float and uint8 shipping), ``collate_train`` and the
loader's batch order (thread and process workers), on a tiny synthetic
DUTS directory.

Both packages have a native (C++) and a NumPy path for the augmentations,
which differ by ulps in ``color_jitter``'s clip passes.  Each comparison
runs both packages on one path: the one ``sod_tpu``'s library gave this
process (its in-place ``make`` may lose a race between test processes,
which leaves ``sod_tpu`` on NumPy), and, in
``test_numpy_paths_are_byte_equal``, with both libraries forced off."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sod_tpu import native as jnative
from sod_tpu.data import augment as jaug
from sod_tpu.data.duts import DUTSDataset as JaxDUTS
from sod_tpu.data.loader import DataLoader as JaxLoader
from sod_tpu.data.loader import collate_train as jax_collate
from sod_tpu.ops import rle as jax_rle
from sod_tpu_torch.data import augment as taug
from sod_tpu_torch.data.duts import DUTSDataset
from sod_tpu_torch import native as tnative
from sod_tpu_torch.data.loader import DataLoader, collate_train, stable_label
from sod_tpu_torch.ops import rle


def _native_off(monkeypatch, module) -> None:
    """The package's native library unavailable for this test: ``lib()``
    returns None, so its callers take their NumPy paths."""
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(module, "_tried", True)


@pytest.fixture(autouse=True)
def same_native_path(monkeypatch):
    """Both packages on one path: where either library is unavailable in
    this process, the other is switched off for the test."""
    if jnative.lib() is None or tnative.lib() is None:
        _native_off(monkeypatch, jnative)
        _native_off(monkeypatch, tnative)


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


def test_normalize_device_keeps_its_values():
    """``normalize_device`` reads its mean and std from tensors made once per
    device: the values are those of the tensors it built on every call, and
    ``normalize``'s (both packages') on the host."""
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 5, 7, 3),
                                                           dtype=np.uint8))
    mean = torch.tensor(taug.IMAGENET_MEAN, dtype=torch.float32)
    std = torch.tensor(taug.IMAGENET_STD, dtype=torch.float32)
    want = (u8.float() / 255.0 - mean) / std
    for _ in range(2):
        assert torch.equal(taug.normalize_device(u8), want)
    np.testing.assert_array_equal(want.numpy(), taug.normalize(u8.numpy()))
    np.testing.assert_array_equal(want.numpy(), jaug.normalize(u8.numpy()))
    cached = taug._mean_std(u8.device)
    assert cached is taug._mean_std(u8.device)
    assert torch.equal(cached[0], mean) and torch.equal(cached[1], std)


def test_augmentations_are_byte_equal():
    _check_augmentations()


def _check_augmentations():
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
    _check_duts_samples(duts_dir, u8)


def _check_duts_samples(duts_dir, u8):
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
    _check_loader_order(duts_dir)


def test_process_loader_batch_order_is_sod_tpu_order(duts_dir):
    """``use_processes=True`` (forked workers, the dataset through the
    initializer): every batch's order and bytes equal ``sod_tpu``'s loader
    (whose process workers its own tests hold to its threads)."""
    _check_loader_order(duts_dir, torch_procs=True)


def _check_loader_order(duts_dir, torch_procs=False):
    jds, tds = _datasets(duts_dir, True)
    orders = []
    for ds, cls, coll, procs in ((jds, JaxLoader, jax_collate, False),
                                 (tds, DataLoader, collate_train, torch_procs)):
        loader = cls(ds, batch_size=3, shuffle=True, num_workers=2, seed=5,
                     collate_fn=lambda s, c=coll: c(s, 2, 3), use_processes=procs)
        loader.set_epoch(4)
        assert len(loader) == 3
        orders.append([b for b in loader])
    assert len(orders[0]) == len(orders[1]) == 3
    for ja, ta in zip(*orders):
        assert ja.keys() == ta.keys()
        assert ja["filename"] == ta["filename"]
        for k in ja:
            if k != "filename":
                np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)


@pytest.mark.parametrize("case", ["augmentations", "duts_float", "duts_u8", "loader",
                                  "process_loader"])
def test_numpy_paths_are_byte_equal(duts_dir, monkeypatch, case):
    """Both native libraries forced off: the NumPy paths compared on every
    run, whichever path the tests above took."""
    _native_off(monkeypatch, jnative)
    _native_off(monkeypatch, tnative)
    assert not jnative.available() and not tnative.available()
    {"augmentations": _check_augmentations,
     "duts_float": lambda: _check_duts_samples(duts_dir, False),
     "duts_u8": lambda: _check_duts_samples(duts_dir, True),
     "loader": lambda: _check_loader_order(duts_dir),
     "process_loader": lambda: _check_loader_order(duts_dir, torch_procs=True)}[case]()
