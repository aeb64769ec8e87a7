"""Surfaces of ``sod_tpu`` that the port lacked, on the CPU at a tiny size:
``Trainer.__call__`` (train then evaluate, epoch by epoch) with an injected
``evaluator=``; the reference command lines' ``--gpu_id`` / ``--use_gpu``
flags and the web app's ``--no-model``; ``get_dataset``'s errors for the
dataset names the reference factory mentions without a class."""
import json
import os

import numpy as np
import pytest
import yaml
from PIL import Image

from sod_tpu.config import Config
from sod_tpu.data.factory import get_dataset as jax_get_dataset
from sod_tpu_torch.cli import evaluate as cli_evaluate
from sod_tpu_torch.cli import train as cli_train
from sod_tpu_torch.data.factory import get_dataset
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops import rle
from sod_tpu_torch.serving import app as port_app
from sod_tpu_torch.serving import inference as port_inference
from sod_tpu_torch.train.evaluator import Evaluator
from sod_tpu_torch.train.trainer import Trainer

TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
    patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4, use_flash=True))
TE_SIZES = [(40, 48), (32, 32), (56, 24)]


@pytest.fixture()
def settings(tmp_path):
    """A synthetic DUTS directory: 4 train images with RLE pseudo masks at
    32 px and 3 test images with their ground truth."""
    r = np.random.default_rng(0)
    duts = tmp_path / "DUTS"
    for sub in ("DUTS-TR-Image", "DUTS-TE-Image", "DUTS-TE-Mask"):
        (duts / sub).mkdir(parents=True)
    masks = {}
    for i in range(4):
        im = (r.random((40, 48, 3)) * 50).astype(np.uint8)
        im[5:25, 10:30] += 170
        Image.fromarray(im).save(duts / "DUTS-TR-Image" / f"tr_{i}.jpg")
        gt = np.zeros((32, 32), np.uint8)
        gt[4:20, 7:20] = 1
        masks[f"tr_{i}.jpg"] = rle.encode(gt)
    for i, (h, w) in enumerate(TE_SIZES):
        im = (r.random((h, w, 3)) * 60).astype(np.uint8)
        im[h // 4:3 * h // 4, w // 5:4 * w // 5] += 150
        Image.fromarray(im).save(duts / "DUTS-TE-Image" / f"te_{i}.jpg")
        gt = np.zeros((h, w), np.uint8)
        gt[h // 4:3 * h // 4, w // 5:4 * w // 5] = 255
        Image.fromarray(gt).save(duts / "DUTS-TE-Mask" / f"te_{i}.png")
    (tmp_path / "pm.json").write_text(json.dumps(masks))
    return dict(dir_ckpt=str(tmp_path / "ckpt"), dir_dataset=str(tmp_path),
                pseudo_masks_fp=str(tmp_path / "pm.json"), batch_size=4,
                num_workers=2, max_gt_masks=2, train_image_size=32, n_epochs=1,
                lr=1e-4, compute_dtype="float32", benchmarks=["duts"])


def _records(trainer):
    with open(os.path.join(trainer.dir_ckpt, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_call_trains_and_evaluates_each_epoch(settings, capsys):
    trainer = Trainer(Config(**settings), device="cpu", mcfg=TCFG)
    assert trainer(n_epochs=2) is None
    records = _records(trainer)
    assert [r["epoch"] for r in records if "avg_loss" in r] == [1, 2]
    evals = [r for r in records if "iou (DUTS)" in r]
    assert [r["step"] for r in evals] == [1, 2]
    assert all(np.isfinite(r["iou (DUTS)"]) for r in evals)
    assert trainer.n_iters_done == 2 and os.path.isfile(trainer.latest_path)
    for epoch in ("01", "02"):
        assert os.path.isfile(os.path.join(trainer.dir_ckpt, "eval", "duts", epoch,
                                           "metrics_duts.txt"))
    out = capsys.readouterr().out
    assert "epoch 1: loss" in out and "epoch 2: loss" in out


def test_trainer_call_defaults_to_the_configs_epochs(settings):
    trainer = Trainer(Config(**dict(settings, n_epochs=1)), device="cpu", mcfg=TCFG)
    trainer(device="cpu")            # sod_tpu's signature: device accepted, unused
    assert [r["epoch"] for r in _records(trainer) if "avg_loss" in r] == [1]


def test_trainer_calls_the_injected_evaluator_with_its_weights(settings):
    cfg = Config(**settings)
    calls = []

    class Spy(Evaluator):
        def __call__(self, dataset_name, **kw):
            calls.append((dataset_name, self.model))
            return super().__call__(dataset_name, **kw)

    from sod_tpu_torch.models.maskformer import MaskFormer, random_state_dict

    other = MaskFormer(TCFG)
    other.load_state_dict(random_state_dict(other, 7))
    spy = Spy(other, cfg, TCFG, device="cpu")
    trainer = Trainer(cfg, device="cpu", mcfg=TCFG, evaluator=spy)
    assert trainer.evaluator is spy
    trainer(n_epochs=2)
    # the injected evaluator ran each epoch, on the Trainer's current model
    assert [name for name, _ in calls] == ["duts", "duts"]
    assert all(model is trainer.model for _, model in calls)
    assert trainer.evaluator is spy and len(
        [r for r in _records(trainer) if "iou (DUTS)" in r]) == 2


def test_train_cli_calls_the_trainer(settings, tmp_path, monkeypatch, capsys):
    """``main`` hands the epochs to ``Trainer.__call__``, with the epoch
    ``resume()`` returned."""
    seen = []

    class _Trainer:
        dir_ckpt = "unused"

        def __init__(self, cfg, **kw):
            self.kw = kw

        def resume(self):
            return 3

        def __call__(self, n_epochs=None, device=None, start_epoch=1):
            seen.append((n_epochs, start_epoch, self.kw["device"]))

    monkeypatch.setattr("sod_tpu_torch.train.trainer.Trainer", _Trainer)
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump(dict(settings, n_epochs=5)))
    cli_train.main(["--config", str(fp), "--device", "cpu", "--gpu_id", "0"])
    cli_train.main(["--config", str(fp), "--device", "cpu", "--resume"])
    assert seen == [(5, 1, "cpu"), (5, 3, "cpu")]


@pytest.mark.parametrize("module,argv", [
    (cli_train, ["--config", "x.yaml", "--gpu_id", "0"]),
    (cli_evaluate, ["--config", "x.yaml", "--gpu_id", "0"]),
    (cli_evaluate, ["--config", "x.yaml", "--use_gpu", "True", "--gpu_id", "1"])])
def test_reference_command_lines_parse(module, argv):
    """``sod_tpu``'s parsers take the same flags (accepted, unused)."""
    import importlib

    args = module.build_argparser().parse_args(argv)
    assert args.gpu_id == int(argv[argv.index("--gpu_id") + 1])
    twin = importlib.import_module(module.__name__.replace("sod_tpu_torch", "sod_tpu"))
    ref = twin.build_argparser().parse_args(argv)
    assert ref.gpu_id == args.gpu_id
    if "--use_gpu" in argv:
        assert args.use_gpu == ref.use_gpu


def test_app_main_without_a_model_builds_none(monkeypatch):
    served = {}

    class _Never:
        def __init__(self, **kw):
            raise AssertionError("--no-model must not build SelfMaskInference")

    class _Stop(Exception):
        pass

    def no_server(host, port, app):
        served["app"] = app
        raise _Stop

    monkeypatch.setenv("SOD_DB_PATH", ":memory:")
    monkeypatch.setattr(port_inference, "SelfMaskInference", _Never)
    monkeypatch.setattr("sod_tpu_torch.serving.web.make_threaded_server", no_server)
    with pytest.raises(_Stop):
        port_app.main(["--no-model", "--port", "0"])
    assert served["app"].inference is None


@pytest.mark.parametrize("name", ["cub2011", "flowers102", "hku_is", "sod", "imagenet1k"])
def test_get_dataset_names_the_absent_class(tmp_path, name):
    with pytest.raises(NotImplementedError) as ref:
        jax_get_dataset(str(tmp_path), name, "test")
    with pytest.raises(NotImplementedError) as got:
        get_dataset(str(tmp_path), name, "test")
    assert str(got.value) == str(ref.value) and name in str(got.value)


def test_get_dataset_keeps_its_other_errors(tmp_path):
    with pytest.raises(ValueError, match="Invalid dataset_name"):
        get_dataset(str(tmp_path), "coco", "test")
    with pytest.raises(ValueError):
        get_dataset(str(tmp_path), "duts", "val")
    (tmp_path / "ECSSD" / "images").mkdir(parents=True)
    (tmp_path / "ECSSD" / "images" / "im0.jpg").write_bytes(b"")     # no mask
    with pytest.raises(FileNotFoundError):
        get_dataset(str(tmp_path), "ecssd", "test")
