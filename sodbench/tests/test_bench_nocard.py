"""The measurement path refuses to run without a card: a non-zero exit and
no result line, also in a directory that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from sodbench import harness


def _run(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "sodbench.run", "--workload", "vits8-train-b64",
                           "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0
    _no_result(out)
    assert "no card" in out.stderr or "cards" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "sodbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


def test_require_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(harness.NoCard):
        harness.require_cards(1)
