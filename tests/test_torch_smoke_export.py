"""The port's installation smoke test (``sod_tpu_torch.cli.smoke``) and its
export CLI (``sod_tpu_torch.cli.export``) on the CPU.

The export is held to ``sod_tpu``'s ``save_torch_checkpoint`` on the same
parameters (carried over with ``convert.state_dict_from_jax``): the same
keys, arrays equal exactly (both f32), the same ``extra`` fields."""
import jax
import numpy as np
import pytest
import torch

from sod_tpu.models.convert import load_torch_state_dict as jax_load
from sod_tpu.models.convert import save_torch_checkpoint as jax_save
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu_torch.cli import export, smoke
from sod_tpu_torch.models.convert import load_torch_state_dict, state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.train.checkpoints import save_checkpoint

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, maskformer_init(jax.random.key(0), JaxMaskFormerConfig(
        n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT))))


def test_smoke_passes_on_the_cpu(capsys):
    """The live config at full width with seeded weights, on the CPU."""
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("imports", "device", "model build + forward"):
        assert f"[PASS] {name}" in out
    assert "mask_pred (1, 6, 20, 56, 56)" in out and "3 passed, 0 failed" in out


def test_smoke_fails_without_the_card_or_with_an_orbax_directory(tmp_path, capsys,
                                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) == 1                         # --device cuda by default
    out = capsys.readouterr().out
    assert "[FAIL] device" in out and "[PASS] imports" in out
    assert smoke.main(["--device", "cpu", "--p_state_dict", str(tmp_path)]) == 1
    assert "[FAIL] model build + forward" in capsys.readouterr().out


def _port_model(params):
    model = MaskFormer(MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT)))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()})
    return model


def test_export_of_a_trainer_checkpoint_is_sod_tpus_file(params, tmp_path):
    save_checkpoint(str(tmp_path / "latest_model.pt"), _port_model(params), epoch=3,
                    n_iters=27)
    export.main(["--ckpt", str(tmp_path / "latest_model.pt"), "--out", str(tmp_path / "o.pt")])
    jax_save(str(tmp_path / "ref.pt"), params, extra={"n_epochs": 3, "n_iters": 27})
    ours = torch.load(tmp_path / "o.pt", weights_only=True)
    theirs = torch.load(tmp_path / "ref.pt", weights_only=True)
    assert set(ours) == set(theirs) == {"model", "n_epochs", "n_iters"}
    assert (ours["n_epochs"], ours["n_iters"]) == (theirs["n_epochs"], theirs["n_iters"])
    got, want = load_torch_state_dict(str(tmp_path / "o.pt")), jax_load(str(tmp_path / "ref.pt"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k


def test_export_rewraps_a_state_dict_and_refuses_an_orbax_directory(params, tmp_path):
    sd = _port_model(params).state_dict()
    torch.save(sd, tmp_path / "bare.pt")
    export.main(["--ckpt", str(tmp_path / "bare.pt"), "--out", str(tmp_path / "o.pt")])
    out = torch.load(tmp_path / "o.pt", weights_only=True)
    assert set(out) == {"model"}
    assert all(torch.equal(out["model"][k], v) for k, v in sd.items())
    (tmp_path / "best_model_duts").mkdir()
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        export.main(["--ckpt", str(tmp_path / "best_model_duts"), "--out",
                     str(tmp_path / "x.pt")])
    assert not (tmp_path / "x.pt").exists()
