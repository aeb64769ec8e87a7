"""Surfaces of ``sod_tpu`` that the port lacked, on the CPU at a tiny size:
``Trainer.__call__`` (train then evaluate, epoch by epoch) with an injected
``evaluator=``; the reference command lines' ``--gpu_id`` / ``--use_gpu``
flags and the web app's ``--no-model``; ``get_dataset``'s errors for the
dataset names the reference factory mentions without a class; the
evaluate CLI's refusal of an orbax directory (ROADMAP fault F1) and the
Trainer's dataset built through ``get_dataset`` (fault F2);
``learnable_pixel_decoder: true``, which ``sod_tpu`` runs as the bilinear
forward (fault F3); the service's, the Evaluator's and the Trainer's errors
for the non-bc head, and the Trainer's skipped evaluation for the ResNet
(fault F4); ``use_copy_paste: true`` and ``loss_every_decoder_layer:
false``, which ``sod_tpu`` carries and never reads (fault F5)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
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
    ``resume()`` returned, then waits for the last checkpoint write."""
    seen = []

    class _Trainer:
        dir_ckpt = "unused"

        def __init__(self, cfg, **kw):
            self.kw = kw

        def resume(self):
            return 3

        def __call__(self, n_epochs=None, device=None, start_epoch=1):
            seen.append((n_epochs, start_epoch, self.kw["device"]))

        def wait_for_checkpoints(self):
            seen.append("wait")

    monkeypatch.setattr("sod_tpu_torch.train.trainer.Trainer", _Trainer)
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump(dict(settings, n_epochs=5)))
    cli_train.main(["--config", str(fp), "--device", "cpu", "--gpu_id", "0"])
    cli_train.main(["--config", str(fp), "--device", "cpu", "--resume"])
    assert seen == [(5, 1, "cpu"), "wait", (5, 3, "cpu"), "wait"]


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


# ------------------------------------------- F1: one rule for a weights path

def _evaluate_argv(tmp_path, weights):
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump({"dir_dataset": str(tmp_path)}))
    return ["--config", str(fp), "--device", "cpu", "--dir_root", str(tmp_path),
            "--p_state_dict", str(weights)]


def test_evaluate_cli_refuses_an_orbax_directory_as_the_service_does(tmp_path):
    """A checkpoint directory is refused with the service's item-13
    ``NotImplementedError`` (it was an ``IsADirectoryError`` from
    ``torch.load``)."""
    ckpt = tmp_path / "best_model_duts"
    ckpt.mkdir()
    with pytest.raises(NotImplementedError, match="ROADMAP item 13") as got:
        cli_evaluate.main(_evaluate_argv(tmp_path, ckpt))
    with pytest.raises(NotImplementedError) as want:
        port_inference.SelfMaskInference(cfg=Config(), device="cpu", model_path=str(ckpt),
                                          warmup=False)
    assert str(got.value) == str(want.value)


def test_evaluate_cli_still_loads_a_torch_checkpoint(tmp_path, monkeypatch):
    from sod_tpu_torch.models.maskformer import MaskFormer, random_state_dict

    sd = random_state_dict(MaskFormer(TCFG), 3)
    import torch

    torch.save({"model": sd}, tmp_path / "w.pt")
    seen = {}

    class _Evaluator:
        def __init__(self, model, *a, **kw):
            seen["model"] = model

        def __call__(self, **kw):
            return {"iou": 0.0}

    monkeypatch.setattr("sod_tpu_torch.models.maskformer.config_from", lambda cfg: TCFG)
    monkeypatch.setattr("sod_tpu_torch.train.evaluator.Evaluator", _Evaluator)
    assert cli_evaluate.main(_evaluate_argv(tmp_path, tmp_path / "w.pt")) == {"iou": 0.0}
    loaded = seen["model"].state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())


# --------------------------------------- F2: the train split via get_dataset

@pytest.mark.parametrize("name,error", [("foo", ValueError), ("cub2011", NotImplementedError),
                                        ("ecssd", ValueError)])
def test_trainer_raises_the_factorys_error_for_a_dataset_without_a_train_split(
        settings, name, error):
    """As ``sod_tpu``'s Trainer, which calls ``get_dataset(..., mode="train")``:
    an unknown name and a name without a class give ``sod_tpu``'s error and
    message; ``ecssd`` the port factory's ``ValueError`` (an ``assert`` in
    ``sod_tpu``).  The port raised "trains on duts only" for all three."""
    with pytest.raises(error) as got:
        Trainer(Config(**dict(settings, dataset_name=name)), device="cpu", mcfg=TCFG)
    with pytest.raises(error) as want:
        get_dataset(settings["dir_dataset"], name, mode="train")
    assert str(got.value) == str(want.value)
    if name != "ecssd":
        with pytest.raises(error) as ref:
            jax_get_dataset(settings["dir_dataset"], name, mode="train")
        assert str(got.value) == str(ref.value)


def test_trainer_builds_the_duts_train_split_as_before(settings):
    from sod_tpu_torch.data.duts import DUTSDataset
    from sod_tpu_torch.train.trainer import train_dataset

    cfg = Config(**settings)
    got = train_dataset(cfg)
    want = DUTSDataset(os.path.join(cfg.dir_dataset, "DUTS"), img_size=cfg.train_image_size,
                       scale_range=cfg.scale_range, use_pseudo_masks=cfg.use_pseudo_masks,
                       pseudo_masks_fp=cfg.pseudo_masks_fp,
                       use_copy_paste=cfg.use_copy_paste)
    want.set_mode("train")
    assert type(got) is DUTSDataset and got.mode == "train" and len(got) == 4
    for attr in ("p_train_imgs", "p_train_gts", "pseudo_masks", "img_size", "scale_range",
                 "use_pseudo_masks", "use_copy_paste", "use_aug"):
        assert getattr(got, attr) == getattr(want, attr), attr


# ---------------------------- F3: learnable_pixel_decoder is the bilinear one

def test_learnable_pixel_decoder_runs_the_bilinear_forward():
    """``sod_tpu`` accepts ``learnable_pixel_decoder: true`` and never reads
    it; the port refused the config.  Now both accept it and the forward is
    the ``False`` one, bit for bit."""
    from sod_tpu.models.maskformer import config_from as jax_config_from
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict

    cfg = Config(learnable_pixel_decoder=True)
    assert jax_config_from(cfg).learnable_pixel_decoder
    mcfg = config_from(cfg)
    assert mcfg.learnable_pixel_decoder
    assert mcfg == dataclasses.replace(config_from(Config()), learnable_pixel_decoder=True)
    models = [MaskFormer(c) for c in (mcfg, config_from(Config()))]
    sd = random_state_dict(models[0], 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    outs = []
    for m in models:
        m.load_state_dict(sd)
        with torch.no_grad():
            outs.append(m(x))
    assert set(outs[0]) == {"mask_pred", "objectness", "features"}
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


# ------ F5: use_copy_paste and loss_every_decoder_layer are carried, not read

@pytest.mark.parametrize("key,value", [("use_copy_paste", True),
                                       ("loss_every_decoder_layer", False)])
def test_settings_sod_tpu_carries_and_ignores_leave_the_step_as_it_is(key, value):
    """The port refused both settings.  Now, with either flipped, the port
    and ``sod_tpu`` each take one f32 step from shared weights (the models'
    configs through each package's ``config_from``, cut to the tiny ViT):
    each side's losses and parameters equal its step with the setting
    unflipped, bit for bit, and the port's step equals ``sod_tpu``'s
    (metrics within 1e-5 relative, updates as ``test_torch_train_step.py``'s
    f32 steps)."""
    import jax
    import jax.numpy as jnp

    from sod_tpu.models.maskformer import config_from as jax_config_from
    from sod_tpu.models.maskformer import maskformer_init
    from sod_tpu.models.vit import ViTConfig as JaxViTConfig
    from sod_tpu.train.optim import build_optimizer as jax_build_optimizer
    from sod_tpu.train.step import make_train_step as jax_make_train_step
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from
    from sod_tpu_torch.train.optim import build_optimizer
    from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step

    vit = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4, use_flash=False)
    r = np.random.default_rng(11)
    gt = np.zeros((4, 2, 32, 32), np.uint8)
    gt[:, 0, 6:20, 4:26] = 1
    batch = {"image": r.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8), "gt_masks": gt,
             "gt_valid": np.array([[True, False]] * 4),
             "labels": np.array([3, 3, 8, 8], np.int32)}
    live = Config(batch_size=4, lr=1e-3, n_epochs=2, compute_dtype="float32")
    runs = {}
    for name, cfg in (("live", live), ("flipped", dataclasses.replace(live, **{key: value}))):
        jcfg = dataclasses.replace(jax_config_from(cfg), n_queries=4, n_decoder_layers=2,
                                   vit=JaxViTConfig(**vit))
        tcfg = dataclasses.replace(config_from(cfg), n_queries=4, n_decoder_layers=2,
                                   vit=ViTConfig(**vit))
        assert jcfg.return_intermediate == tcfg.return_intermediate == \
            cfg.loss_every_decoder_layer
        params = maskformer_init(jax.random.key(0), jcfg)
        old = state_dict_from_jax(jax.tree.map(np.asarray, params))
        model = MaskFormer(tcfg)
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in old.items()})
        tx = jax_build_optimizer(cfg, 2)
        params, _, jm = jax_make_train_step(cfg, tx, jcfg)(
            params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
        tm = make_train_step(cfg, model, build_optimizer(cfg, model.parameters(), 2))(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        new = state_dict_from_jax(jax.tree.map(np.asarray, params))
        runs[name] = ({k: float(jm[k]) for k in METRIC_KEYS},
                      {k: new[k] - old[k] for k in new},
                      {k: float(tm[k]) for k in METRIC_KEYS},
                      {k: v.numpy() - old[k] for k, v in model.state_dict().items()})
    (jm, ju, tm, tu), flipped = runs["live"], runs["flipped"]
    assert flipped[0] == jm and flipped[2] == tm
    for k in ju:
        np.testing.assert_array_equal(flipped[1][k], ju[k], err_msg=k)
        np.testing.assert_array_equal(flipped[3][k], tu[k], err_msg=k)
        np.testing.assert_allclose(tu[k], ju[k], atol=1e-5, rtol=1e-3, err_msg=k)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert tm["contrastive_loss"] > 0


def test_use_copy_paste_reaches_the_dataset_and_is_not_read(settings):
    """As in ``sod_tpu``: ``DUTSDataset`` stores it and samples the same."""
    from sod_tpu_torch.train.trainer import train_dataset

    samples = []
    for flag in (False, True):
        ds = train_dataset(Config(**settings, use_copy_paste=flag))
        assert ds.use_copy_paste is flag
        ds.set_mode("train")
        ds.seed, ds.epoch = 1, 1
        samples.append(ds[2])
    assert samples[0].keys() == samples[1].keys()
    for k in samples[0]:
        np.testing.assert_array_equal(samples[0][k], samples[1][k], err_msg=k)


# ------------------ F4: the non-bc head's errors are sod_tpu's, and its Trainer

@pytest.mark.parametrize("extra", [{}, {"quantize": "int8", "arch": "resnet50"}])
def test_service_refuses_the_non_bc_head_with_sod_tpus_error(extra):
    """Checked first, before the int8 + resnet check, as in ``sod_tpu``."""
    from sod_tpu.serving.inference import SelfMaskInference as JaxInference

    cfg = Config(use_binary_classifier=False, compute_dtype="float32", **extra)
    with pytest.raises(ValueError) as got:
        port_inference.SelfMaskInference(cfg=cfg, device="cpu", warmup=False)
    with pytest.raises(ValueError) as want:
        JaxInference(cfg=cfg, warmup=False)
    assert str(got.value) == str(want.value)
    assert "serving requires use_binary_classifier=True" in str(got.value)


def test_evaluator_refuses_the_non_bc_head_with_sod_tpus_error(tmp_path):
    from sod_tpu.train.evaluator import Evaluator as JaxEvaluator

    cfg = Config(dir_dataset=str(tmp_path), use_binary_classifier=False)
    with pytest.raises(ValueError) as got:
        Evaluator(None, cfg, device="cpu")
    with pytest.raises(ValueError) as want:
        JaxEvaluator(None, cfg)
    assert str(got.value) == str(want.value) and "objectness" in str(got.value)


def test_trainer_with_the_non_bc_head_trains_then_fails_on_evaluation(settings):
    """``sod_tpu``'s Trainer builds the non-bc model and trains it on the
    contrastive term alone; its evaluation raises the Evaluator's error."""
    cfg = Config(**dict(settings, use_binary_classifier=False))
    trainer = Trainer(cfg, device="cpu",
                      mcfg=dataclasses.replace(TCFG, use_binary_classifier=False))
    with pytest.raises(ValueError, match="Evaluator requires use_binary_classifier=True"):
        trainer(n_epochs=1)
    (rec,) = [r for r in _records(trainer) if "avg_loss" in r]
    assert rec["avg_dice_loss"] == rec["avg_ranking_loss"] == 0.0
    assert np.isfinite(rec["avg_loss"]) and os.path.isfile(trainer.latest_path)


def test_trainer_with_the_resnet_trains_and_skips_the_canvas_evaluation(settings):
    """``sod_tpu``'s canvas forward asserts the ViT encoder and its Trainer
    logs the benchmark as skipped; so does the port's, on its ValueError.
    The BN buffers follow the batches."""
    mcfg = dataclasses.replace(TCFG, arch="resnet50")
    trainer = Trainer(Config(**dict(settings, arch="resnet50")), device="cpu", mcfg=mcfg)
    before = trainer.model.encoder.bn1.running_mean.clone()
    trainer(n_epochs=1)
    records = _records(trainer)
    assert [r["eval_skipped"] for r in records if "eval_skipped" in r] == ["duts"]
    assert "canvas path is for the ViT encoder" in [
        r for r in records if "eval_skipped" in r][0]["reason"]
    assert np.isfinite([r for r in records if "avg_loss" in r][0]["avg_loss"])
    assert not torch.equal(trainer.model.encoder.bn1.running_mean, before)
