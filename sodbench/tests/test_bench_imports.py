"""What the benchmark's process may load: nothing of JAX or of the JAX
package (compared by whole top-level names, since the port's name begins
with the JAX package's), and a reference that imports nothing of the
program."""
import ast
import os
import subprocess
import sys
from glob import glob

import pytest

from sodbench import harness

REF_DIR = os.path.join(harness.BENCH_DIR, "reference")


@pytest.mark.parametrize("path", sorted(glob(os.path.join(REF_DIR, "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"sod_tpu_torch", "sod_tpu", "jax", "jaxlib", "flax"}, tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "numpy", "torch", "sodbench"}


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sod_tpu_torch_fake_probe", sys)
    assert "sod_tpu_torch_fake_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sod_tpu.fake_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"sod_tpu.fake_probe", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sodbench.run, sodbench.calibrate\n"
            "from sodbench.drivers import train, serve, evalcanvas\n"
            "import sod_tpu_torch.serving.inference, sod_tpu_torch.train.step\n"
            "import sod_tpu_torch.train.evaluator, sod_tpu_torch.train.optim\n"
            "import sod_tpu_torch.models.maskformer\n"
            "from sodbench import harness\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
