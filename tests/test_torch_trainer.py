"""The port's Trainer and ``cli/train.py`` on a tiny synthetic DUTS
workspace, on the CPU: one epoch of the small model gives finite metrics,
writes ``latest_model.pt`` and logs the evaluation of each benchmark as
skipped (the workspace holds no test split); ``resume``
restores the iteration count, the parameters and the optimizer; the CLI
trains, takes ``--n_devices`` and ``--fsdp``, refuses ``sod_tpu``'s
model-sharding flags, and imports no jax."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sod_tpu.config import Config
from sod_tpu_torch.cli import train as cli
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.ops import rle
from sod_tpu_torch.train.trainer import Trainer

TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
    patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4, use_flash=True))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def workspace(tmp_path):
    """6 DUTS-TR images (a bright box on a dark ground), their RLE pseudo
    masks at 32 px, and a yaml config for them."""
    tr = tmp_path / "DUTS" / "DUTS-TR-Image"
    tr.mkdir(parents=True)
    r = np.random.default_rng(0)
    masks = {}
    for i in range(6):
        im = (r.random((40, 48, 3)) * 50).astype(np.uint8)
        im[5:25, 10:30] += 170
        Image.fromarray(im).save(tr / f"tr_{i}.jpg")
        gt = np.zeros((32, 32), np.uint8)
        gt[4:20, 7:20] = 1
        masks[f"tr_{i}.jpg"] = rle.encode(gt)
    pm = tmp_path / "pm.json"
    pm.write_text(json.dumps(masks))
    settings = dict(dir_ckpt=str(tmp_path / "ckpt"), dir_dataset=str(tmp_path),
                    pseudo_masks_fp=str(pm), batch_size=4, num_workers=2,
                    max_gt_masks=2, train_image_size=32, n_epochs=1, lr=1e-4,
                    compute_dtype="float32")
    fp = tmp_path / "cfg.yaml"
    fp.write_text(yaml.safe_dump(settings))
    return settings, str(fp)


def test_epoch_checkpoint_resume(workspace):
    settings, _ = workspace
    cfg = Config(**settings)
    trainer = Trainer(cfg, device="cpu", mcfg=TCFG)
    assert trainer.n_iters_per_epoch == 2
    metrics = trainer._train_epoch(1)
    trainer._evaluate(1)
    for k in ("avg_loss", "avg_dice_loss", "avg_iou", "avg_grad_norm"):
        assert np.isfinite(metrics[k]), k
    assert os.path.isfile(trainer.latest_path)
    with open(os.path.join(trainer.dir_ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records[0]["step"] == 2 and records[0]["epoch"] == 1
    assert [r["eval_skipped"] for r in records[1:]] == ["ecssd", "duts", "dut_omron"]
    assert all("no test images" in r["reason"] for r in records[1:])
    assert not any(n.startswith("best_model") for n in os.listdir(trainer.dir_ckpt))

    fresh = Trainer(cfg, device="cpu", mcfg=TCFG)
    assert fresh.resume() == 2
    assert fresh.n_iters_done == 2 and fresh.optimizer.count == 2
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(trainer.optimizer.nu, fresh.optimizer.nu):
        assert torch.equal(a, b)


@pytest.fixture()
def two_threads():
    """The CLI trains the full-width model; keep its CPU threads from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_trains_and_resumes(workspace, capsys, two_threads):
    """The full-width live model (ViT-S/8, 6 decoder layers, 20 queries) at
    32 px: one step of batch 4 over the first 4 images, then --resume."""
    settings, fp = workspace
    pm = json.loads(open(settings["pseudo_masks_fp"]).read())
    with open(settings["pseudo_masks_fp"], "w") as f:
        json.dump(dict(sorted(pm.items())[:4]), f)
    cli.main(["--config", fp, "--device", "cpu"])
    assert "epoch 1: loss" in capsys.readouterr().out
    cli.main(["--config", fp, "--device", "cpu", "--resume"])
    assert "resumed; continuing from epoch 2" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--tp", "2"],
                                   ["--pp", "2"], ["--sp", "2"],
                                   ["--fsdp", "zero1"], ["--async-checkpoint"]])
def test_cli_refuses_mesh_flags(workspace, flags, monkeypatch):
    """The model-sharding flags raise (ROADMAP item 12b).  The others are
    accepted (``sod_tpu/cli/train.py:27-54, 96-140``): ``--n_devices 2``
    spawns two ranks of the CLI (recorded here; a spawned CLI runs in
    ``tests/test_torch_data_parallel.py``); ``--fsdp`` sets ``fsdp`` and
    ``--async-checkpoint`` sets ``async_checkpoint`` for the Trainer, and
    the CLI waits for the last write before it returns
    (``sod_tpu/cli/train.py:79-80, 148``)."""
    _, fp = workspace
    argv = ["--config", fp, "--device", "cpu", *flags]
    if flags[0] in ("--tp", "--pp", "--sp"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            cli.main(argv)
        return
    if flags[0] == "--n_devices":
        import sod_tpu_torch.parallel.mesh as mesh_mod

        spawned = []
        monkeypatch.setattr(mesh_mod, "spawn_ranks",
                            lambda fn, n, *args: spawned.append((fn, n, args)))
        cli.main(argv)
        assert spawned == [(cli._rank_main, 2, (argv,))]
        return
    calls = []

    class Recording:
        def __init__(self, cfg, **kw):
            calls.append(("init", cfg.async_checkpoint, cfg.fsdp, kw["mesh"]))
            self.dir_ckpt = cfg.dir_ckpt

        def __call__(self, n_epochs, start_epoch=1):
            calls.append(("train", n_epochs))

        def wait_for_checkpoints(self):
            calls.append(("wait",))

    import sod_tpu_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", Recording)
    cli.main(argv)
    init = (("init", True, "none", None) if flags == ["--async-checkpoint"]
            else ("init", False, "zero1", None))
    assert calls == [init, ("train", 1), ("wait",)]


def test_cli_imports_no_jax():
    code = ("import sys; import sod_tpu_torch.cli.train; "
            "import sod_tpu_torch.train.trainer; "
            "sys.exit(int('jax' in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
