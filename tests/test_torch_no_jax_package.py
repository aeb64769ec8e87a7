"""The port imports nothing of the JAX package.

* Every module under ``sod_tpu_torch/`` and ``chip_smoke.py`` imports in a
  fresh interpreter without ``jax`` and without ``sod_tpu`` (or any
  ``sod_tpu.*``) landing in ``sys.modules``.
* The port keeps its own copies of the jax-free host modules it needs from
  ``sod_tpu``; each copy equals its source once ``sod_tpu_torch.`` is mapped
  back to ``sod_tpu.``, apart from the lines named here, so the copies
  cannot drift silently.
* The port's own ``create_app`` (its templates, its schema) answers the
  signup / login / upload / ``/predict`` flow with the port's service.
"""
import base64
import difflib
import io
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from PIL import Image

import sod_tpu_torch
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu_torch.config import Config
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.serving import inference as port_inference
from sod_tpu_torch.serving.app import create_app
from sod_tpu_torch.serving.db import Database
from tests.test_serving import Client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(sod_tpu_torch.__path__,
                                                        "sod_tpu_torch."))


def test_every_port_module_imports_without_jax_or_sod_tpu():
    mods = _port_modules() + ["chip_smoke"]
    assert len(mods) > 50 and "sod_tpu_torch.serving.app" in mods
    assert {"sod_tpu_torch.ops.fused_block_int8", "sod_tpu_torch.cli.predict"} <= set(mods)
    assert {"sod_tpu_torch.utils.jax_prng", "sod_tpu_torch.data.clusterings",
            "sod_tpu_torch.models.resnet", "sod_tpu_torch.models.deit",
            "sod_tpu_torch.models.factory", "sod_tpu_torch.data.custom",
            "sod_tpu_torch.data.mask_generator", "sod_tpu_torch.cli.generate_masks"} <= set(mods)
    assert {"sod_tpu_torch.postprocess", "sod_tpu_torch.postprocess.bilateral_solver",
            "sod_tpu_torch.serving.pool", "sod_tpu_torch.cli.refine",
            "sod_tpu_torch.cli.smoke", "sod_tpu_torch.cli.export"} <= set(mods)
    assert {"sod_tpu_torch.parallel", "sod_tpu_torch.parallel.mesh",
            "sod_tpu_torch.parallel.fsdp"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'sod_tpu' or m.startswith('sod_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_import_statement_names_sod_tpu():
    import re

    pat = re.compile(r"^\s*(from|import)\s+sod_tpu[.\s]", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "sod_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]        # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits


_TEMPLATES = os.path.join(REPO, "sod_tpu", "serving", "templates")
# copy under sod_tpu_torch/ -> the least share of the source's lines that it
# keeps in order (1: equal line for line)
COPIES = {
    "config.py": 1, "utils/__init__.py": 1, "utils/misc.py": 1, "utils/visualizer.py": 1,
    "native/sodnative.cc": 1, "native/sodimage.cc": 1,
    # differs on purpose: the docstring, and lib() with its helpers, which
    # builds from the port's sources into sod_tpu_torch/_build/
    "native/__init__.py": 0.80,
    "serving/web.py": 1, "serving/emailer.py": 1,
    # differs on purpose: the name of its shared-cache in-memory database, so
    # that both packages' apps can live in one process (as in these tests)
    "serving/db.py": 0.99,
    "serving/payments.py": 1, "serving/analytics.py": 1, "serving/schema.sql": 1,
    # differs on purpose: the docstring, create_app's model service (the
    # port's SelfMaskInference on `device`) and main() (the port's own:
    # `--device`, `--workers` booting the port's pool, no compile cache)
    "serving/app.py": 0.90,
    # differs on purpose: the docstring, the workers hiding the card
    # (CUDA_VISIBLE_DEVICES empty, where sod_tpu pins jax to its CPU backend)
    # and serve_pool's service (the port's SelfMaskInference on `device`)
    "serving/pool.py": 0.95,
}
for _root, _, _names in os.walk(_TEMPLATES):
    for _n in _names:
        COPIES["serving/templates/"
               + os.path.relpath(os.path.join(_root, _n), _TEMPLATES)] = 1


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_equals_its_sod_tpu_source(rel):
    with open(os.path.join(REPO, "sod_tpu", rel)) as f:
        src = f.read().splitlines()
    with open(os.path.join(REPO, "sod_tpu_torch", rel)) as f:
        dst = f.read().replace("sod_tpu_torch.", "sod_tpu.").splitlines()
    if COPIES[rel] == 1:
        assert dst == src
        return
    sm = difflib.SequenceMatcher(a=src, b=dst, autojunk=False)
    same = sum(b.size for b in sm.get_matching_blocks())
    assert same / len(src) >= COPIES[rel], (rel, same, len(src))
    if rel == "serving/app.py":
        end = next(i for i, ln in enumerate(src) if ln.startswith("def main"))
        routes = [ln for ln in src[:end] if "@app.route" in ln]
        assert len(routes) >= 30 and [ln for ln in dst if "@app.route" in ln] == routes
    elif rel == "serving/pool.py":
        heads = [ln for ln in src if ln.startswith(("def ", "class "))]
        assert [ln for ln in dst if ln.startswith(("def ", "class "))] == [
            ln.replace("cfg=None,", 'cfg=None, device="cuda",') for ln in heads]
        assert not [ln for ln in dst if "import jax" in ln]
    elif rel == "serving/db.py":
        assert [ln for ln in difflib.ndiff(src, dst) if ln.startswith("- ")] == [
            '-             self._uri = f"file:sodmem{seq}?mode=memory&cache=shared"']
    else:
        tail = next(i for i, ln in enumerate(src) if ln.startswith("def available"))
        assert dst[-(len(src) - tail):] == src[tail:]      # every wrapper unchanged


def test_both_packages_in_memory_databases_are_separate():
    """The n-th in-memory ``Database`` of each package in one process: a
    user signed up in one must not appear in the other."""
    from sod_tpu.serving.db import Database as JaxDatabase

    ours, theirs = Database(":memory:"), JaxDatabase(":memory:")
    assert ours._uri.split("mem")[0] != theirs._uri.split("mem")[0]
    ours.execute("INSERT INTO user_management (Name, Email, Password) "
                 "VALUES (%s, %s, %s)", ("u", "u@x.com", "p"))
    assert ours.query("SELECT COUNT(*) AS n FROM user_management")[0]["n"] == 1
    assert theirs.query("SELECT COUNT(*) AS n FROM user_management")[0]["n"] == 0


# ------------------------------------------------------ the port's web app

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT))


def _png(h=40, w=48):
    img = np.full((h, w, 3), 25, np.uint8)
    img[10:30, 12:40] = 210
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_ports_app_answers_signup_login_upload_predict(monkeypatch, tmp_path):
    monkeypatch.setattr(port_inference, "config_from", lambda cfg: TCFG)
    params = maskformer_init(jax.random.key(0), JaxMaskFormerConfig(
        n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT)))
    cfg = Config(eval_image_size=32, compute_dtype="float32", micro_batch=False)
    app = create_app(db=Database(":memory:"), load_model=False,
                     upload_dir=str(tmp_path / "static"), secret_key="t")
    app.inference = port_inference.SelfMaskInference(
        cfg=cfg, state_dict=state_dict_from_jax(jax.tree.map(np.array, params)),
        device="cpu", warmup=False)
    c = Client(app)
    st, page = c.get("/")
    assert st == 200 and b"<html" in page.lower()          # the port's templates
    st, r = c.post("/predict", files={"image": ("a.png", _png())})
    assert st == 401
    st, r = c.post("/user_signup", json_body={
        "name": "u", "email": "u@x.com", "password": "p", "phone": ""})
    assert st == 200 and r["success"]
    st, r = c.get(r["verify_url"])
    assert st == 200 and r["success"]
    c2 = Client(app)
    st, r = c2.post("/user_login", json_body={"email": "u@x.com", "password": "p"})
    assert st == 200 and r["success"]
    st, r = c2.post("/save_image_info", files={"image": ("a.png", _png())})
    assert st == 200 and r["success"]
    st, r = c2.post("/predict", files={"image": ("a.png", _png())})
    assert st == 200 and r["success"]
    for key in ("mask", "heatmap", "original"):
        img = Image.open(io.BytesIO(base64.b64decode(r[key])))
        assert img.size == (48, 40), key
    st, r = c2.get("/test_connection")
    assert r["model_loaded"] and r["model"]["n_queries"] == 4
    st, r = c2.get("/test_db")
    assert st == 200


def test_create_app_loads_the_ports_service(monkeypatch):
    """``create_app(load_model=True)`` builds ``sod_tpu_torch``'s
    ``SelfMaskInference`` on the device it is given."""
    seen = {}

    class _Svc:
        def __init__(self, **kw):
            seen.update(kw)

    monkeypatch.setattr(port_inference, "SelfMaskInference", _Svc)
    app = create_app(db=Database(":memory:"), device="cpu", secret_key="t")
    assert isinstance(app.inference, _Svc)
    assert seen["device"] == "cpu" and isinstance(seen["cfg"], Config)


def test_host_library_is_keyed_by_the_cpu(monkeypatch):
    """The host library is built with ``-march=native``: a build directory
    carried to another CPU must not offer its ``.so`` there."""
    from sod_tpu_torch import native

    here = native._library_path()
    assert native._host_id().split()[0] and here == native._library_path()
    monkeypatch.setattr(native, "_host_id", lambda: "x86_64 another cpu")
    assert native._library_path() != here
