"""Each training cell's check, driven as a run drives it (set-up, window,
the program's state freed, the reference) but at a size the CPU holds and
without the look for a card, with the timed path broken underneath: a
state returned unchanged, half of each batch left out.  Each must come out
not correct under the cell's limits; the sound run must come out
correct."""
import pytest

from sodbench import harness
from sodbench.tests.tiny import run_tiny

TRAIN_CELLS = {"vits8-train-b64": "selfmask-vits8-nq20"}


def _correct(cell: str) -> bool:
    driver = run_tiny(TRAIN_CELLS[cell], "train_steps")
    ok, _ = harness.judge(driver.readings(), harness.limits_file(cell))
    return ok


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_sound_run_is_correct(cell):
    assert _correct(cell)


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_state_returned_unchanged(cell, monkeypatch):
    from sod_tpu_torch.train.optim import ClippedAdamW

    monkeypatch.setattr(ClippedAdamW, "step", lambda self, *a, **k: None)
    assert not _correct(cell)


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_half_of_each_batch_left_out(cell, monkeypatch):
    from sod_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step

    def broken(*args, **kwargs):
        inner = make(*args, **kwargs)
        return lambda batch: inner({k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(step_mod, "make_train_step", broken)
    assert not _correct(cell)
