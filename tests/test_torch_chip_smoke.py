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
