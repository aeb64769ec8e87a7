"""The port's offline prediction CLI (``sod_tpu_torch.cli.predict``) on the
CPU with a tiny model: the masks it writes, the ``_1`` suffix for a stem
seen before, static batches padded with the last image, ``--heatmap``,
``--quantize int8``, ``--refine``, and what it refuses.  Its masks are the
service's own (``forward_u8`` + LANCZOS back to the input size), held
against ``sod_tpu`` in ``tests/test_torch_serving.py``.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sod_tpu_torch.cli import predict
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.serving import inference as port_inference

TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
    patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4))
SIZES = {"a/cat.png": (40, 48), "a/dog.png": (30, 30), "b/cat.png": (50, 36)}


@pytest.fixture()
def images(tmp_path, monkeypatch):
    monkeypatch.setattr(port_inference, "config_from", lambda cfg: TCFG)
    rng = np.random.RandomState(0)
    for rel, (h, w) in SIZES.items():
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(tmp_path / rel)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("eval_image_size: 32\nmicro_batch: false\n")
    return tmp_path, ["--config", str(cfg), "--device", "cpu"]


def _run(tmp, base, *extra):
    out = tmp / "out"
    predict.main(["--p_images", str(tmp / "a" / "*.png"), str(tmp / "b" / "*.png"),
                  "--out", str(out), *base, *extra])
    return out


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_writes_a_mask_per_image_and_suffixes_a_repeated_stem(images, quantize):
    tmp, base = images
    forwards = []
    real = port_inference.SelfMaskInference.forward_u8

    def spy(self, batch):
        forwards.append(batch.copy())
        return real(self, batch)

    port_inference.SelfMaskInference.forward_u8 = spy
    try:
        out = _run(tmp, base, "--batch_size", "2", "--heatmap", "--quantize", quantize)
    finally:
        port_inference.SelfMaskInference.forward_u8 = real
    want = {"cat": "a/cat.png", "dog": "a/dog.png", "cat_1": "b/cat.png"}
    assert sorted(os.listdir(out)) == sorted(
        f"{stem}_{kind}.png" for stem in want for kind in ("mask", "heatmap"))
    for stem, rel in want.items():
        h, w = SIZES[rel]
        mask = Image.open(out / f"{stem}_mask.png")
        assert mask.mode == "L" and mask.size == (w, h)
        heat = Image.open(out / f"{stem}_heatmap.png")
        assert heat.mode == "RGB" and heat.size == (w, h)
    # two static batches of 2; the second padded with its last image
    assert [f.shape for f in forwards] == [(2, 32, 32, 3)] * 2
    assert np.array_equal(forwards[1][0], forwards[1][1])


def test_masks_are_the_services(images):
    tmp, base = images
    out = _run(tmp, base)
    from sod_tpu_torch.config import load_config

    svc = port_inference.SelfMaskInference(cfg=load_config(base[1]), device="cpu",
                                           warmup=False)
    img = Image.open(tmp / "a" / "dog.png").convert("RGB")
    small, _ = svc.model_step(np.asarray(img.resize((32, 32), Image.BILINEAR), np.uint8))
    ref = np.asarray(Image.fromarray(small).resize(img.size, Image.LANCZOS))
    got = np.asarray(Image.open(out / "dog_mask.png"))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_overlapping_patterns_predict_an_image_once(images):
    tmp, base = images
    out = tmp / "once"
    predict.main(["--p_images", str(tmp / "a" / "*.png"), str(tmp / "a" / "cat.png"),
                  "--out", str(out), *base])
    assert sorted(os.listdir(out)) == ["cat_mask.png", "dog_mask.png"]


def test_a_pattern_that_matches_nothing_exits(images):
    tmp, base = images
    with pytest.raises(SystemExit, match="matched nothing"):
        predict.main(["--p_images", str(tmp / "a" / "*.png"), str(tmp / "none" / "*.jpg"),
                      "--out", str(tmp / "o"), *base])
    assert not (tmp / "o").exists()


def test_refine_is_refused(images):
    """``--refine`` was refused until the bilateral solver was ported
    (ROADMAP item 10); it now writes ``<stem>_refined.png`` beside each mask:
    the solver's soft mask of that mask on the image, at the image's size."""
    tmp, base = images
    out = tmp / "refined"
    predict.main(["--p_images", str(tmp / "a" / "*.png"), "--refine", "--out", str(out),
                  *base])
    assert sorted(os.listdir(out)) == ["cat_mask.png", "cat_refined.png",
                                       "dog_mask.png", "dog_refined.png"]
    from sod_tpu_torch.postprocess import bilateral_solver_output

    img = Image.open(tmp / "a" / "cat.png").convert("RGB")
    mask = np.asarray(Image.open(out / "cat_mask.png"), np.float32) / 255.0
    soft, _ = bilateral_solver_output(img, mask, device="cpu")
    want = (np.clip(soft, 0, 1) * 255).astype(np.uint8)
    got = Image.open(out / "cat_refined.png")
    assert got.size == img.size and np.array_equal(np.asarray(got), want)


def test_orbax_directories_are_refused(images):
    tmp, base = images
    with pytest.raises(NotImplementedError, match="torch checkpoints only"):
        predict.main(["--p_images", str(tmp / "a" / "*.png"), "--p_state_dict",
                      str(tmp / "ckpt_dir"), "--out", str(tmp / "o"), *base])


def test_a_torch_checkpoint_is_loaded(images):
    tmp, base = images
    from sod_tpu_torch.models.maskformer import MaskFormer, random_state_dict

    sd = random_state_dict(MaskFormer(TCFG), 5)
    torch.save({"model": sd}, tmp / "w.pt")
    out = _run(tmp, base, "--p_state_dict", str(tmp / "w.pt"))
    assert len(os.listdir(out)) == 3
    assert "device" in predict.build_argparser().parse_args(["--p_images", "x"]).__dict__
    assert predict.build_argparser().parse_args(["--p_images", "x"]).device == "cuda"
