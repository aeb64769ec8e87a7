"""``chip_smoke.py`` off the card: what it must refuse to do."""
import sys

import numpy as np
import pytest

import chip_smoke


class _Service:
    """Answers ``model_step`` as the port's service would."""

    class mcfg:
        n_queries = 20

        class vit:
            depth = 12

    def model_step(self, arr):
        return np.zeros(arr.shape[:2], np.uint8), np.zeros(20, np.float32)


class _Cfg:
    eval_image_size = 224


def test_requests_phase_fails_without_pil(monkeypatch):
    """Phase 5 posts real ``/predict`` requests or fails: a missing PIL (or
    yaml) must not turn it into a pass through ``model_step``."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        chip_smoke.requests_phase(_Service(), _Cfg())


def test_main_exits_without_a_card(monkeypatch, capsys):
    """No CUDA device: exit non-zero before printing any result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_k2_bound_and_phase_6_shapes():
    """The K2 bound as a host function of (B, H, N, d, valid keys): 0.00766 ms
    forward and 0.0191 ms backward at the train shape (operations at 989
    TFLOP/s), fewer operations under a key mask; phase 6's shape list holds
    the eval shape and the tile edges, at every head dim."""
    import chip_smoke as cs

    bound = cs.k2_bound(8, 6, 785, 64)
    assert bound["fwd"]["bound_by"] == bound["bwd"]["bound_by"] == "operations"
    assert abs(bound["fwd"]["bound_ms"] - 0.00766) <= 0.01 * 0.00766
    assert abs(bound["bwd"]["bound_ms"] - 0.0191) <= 0.01 * 0.0191
    assert cs.k2_bound(*cs.K2_TRAIN_SHAPE) == bound
    full = cs.k2_bound(*cs.K2_EVAL_SHAPE)["fwd"]["bound_ms"]
    half = cs.k2_bound(*cs.K2_EVAL_SHAPE, valid_keys=16 * 2501 // 2)["fwd"]["bound_ms"]
    assert abs(half - full / 2) <= 1e-9
    # bytes bind where there is one key per query
    assert cs.k2_bound(2, 3, 1, 64)["fwd"]["bound_by"] == "bytes"
    assert cs.K2_EVAL_SHAPE[:3] == (16, 6, 2501) and cs.K2_EVAL_SHAPE[:3] in cs.K2_SHAPES
    assert cs.K2_TRAIN_SHAPE[:3] in cs.K2_SHAPES
    assert {n for _, _, n in cs.K2_SHAPES} == {1, 63, 64, 65, 129, 785, 2501}
    assert cs.K2_HEAD_DIMS == (32, 64, 128)
    mask = cs._canvas_mask(np.random.default_rng(0), 4, 2501)
    assert mask.shape == (4, 2501) and mask[:, 0].all() and not mask.all()
