"""The port's ``/predict`` service (``sod_tpu_torch.serving.inference``)
against ``sod_tpu``'s ``SelfMaskInference`` on the same tiny weights, the
micro-batcher, and an HTTP round trip through ``sod_tpu``'s web app.

Both services run f32 here (``sod_tpu`` off the TPU takes its unfused
path): masks agree within one uint8 level, objectness within 1e-5.
"""
import base64
import io
import threading

import jax
import numpy as np
import pytest
from PIL import Image

from sod_tpu.config import Config
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_apply, maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.serving.app import create_app
from sod_tpu.serving.db import Database
from sod_tpu.serving.inference import SelfMaskInference as JaxInference
from sod_tpu_torch.models.convert import state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.serving import inference as port_inference
from sod_tpu_torch.serving.inference import SelfMaskInference
from tests.test_serving import Client

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)
JCFG = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=JaxViTConfig(**VIT))
TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**VIT))


def _cfg(**kw):
    return Config(eval_image_size=32, compute_dtype="float32",
                  micro_batch=False, **kw)


@pytest.fixture(scope="module")
def params():
    return maskformer_init(jax.random.key(0), JCFG)


@pytest.fixture(autouse=True)
def tiny_model(monkeypatch):
    """The service builds the model of ``config_from(cfg)``: make it tiny."""
    monkeypatch.setattr(port_inference, "config_from", lambda cfg: TCFG)


def _port(params, **kw):
    sd = state_dict_from_jax(jax.tree.map(np.array, params))
    return SelfMaskInference(cfg=kw.pop("cfg", _cfg()), state_dict=sd,
                             device="cpu", **kw)


def _sod_tpu(params):
    svc = JaxInference(cfg=_cfg(), params=params, warmup=False)
    svc.mcfg = JCFG

    @jax.jit
    def forward(p, x):          # as tests/test_serving_inference.py, tiny mcfg
        out = maskformer_apply(p, x, JCFG)
        obj = out["objectness"][:, -1, :, 0]
        best = jax.numpy.argmax(obj, axis=-1)
        sel = jax.numpy.take_along_axis(out["mask_pred"][:, -1],
                                        best[:, None, None, None], axis=1)[:, 0]
        return sel, obj

    svc._forward = forward
    return svc


def _images(rng, n):
    return [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_model_step_matches_sod_tpu(params, rng):
    ours, theirs = _port(params, warmup=False), _sod_tpu(params)
    for img in _images(rng, 3):
        m1, o1 = ours.model_step(img)
        m2, o2 = theirs.model_step(img)
        assert m1.dtype == np.uint8 and m1.shape == m2.shape == (8, 8)
        assert np.abs(m1.astype(int) - m2.astype(int)).max() <= 1
        np.testing.assert_allclose(o1, o2, atol=1e-5, rtol=0)


def test_micro_batcher_serves_concurrent_requests_like_direct_calls(params, rng):
    direct = _port(params, warmup=False)
    batched = _port(params, cfg=_cfg().replace(micro_batch=True,
                                               micro_batch_buckets=(1, 4)))
    try:
        assert batched.micro_batching
        imgs = _images(rng, 12)
        want = [direct.model_step(im) for im in imgs]
        got = [None] * len(imgs)

        def worker(i):
            got[i] = batched.model_step(imgs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for (m1, o1), (m2, o2) in zip(got, want):
            assert np.abs(m1.astype(int) - m2.astype(int)).max() <= 1
            np.testing.assert_allclose(o1, o2, atol=1e-5, rtol=0)
    finally:
        batched.close()


def test_auto_micro_batch_probe_picks_a_policy(params, rng):
    svc = _port(params, cfg=_cfg().replace(micro_batch="auto",
                                           micro_batch_buckets=(1, 4)))
    try:
        assert isinstance(svc.micro_batching, bool)
        mask, obj = svc.model_step(_images(rng, 1)[0])
        assert mask.shape == (8, 8) and obj.shape == (4,)
    finally:
        svc.close()


def _png(h=40, w=48):
    img = np.full((h, w, 3), 25, np.uint8)
    img[10:30, 12:40] = 210
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def client(params, tmp_path):
    app = create_app(db=Database(":memory:"), load_model=False,
                     upload_dir=str(tmp_path / "static"), secret_key="t")
    app.inference = _port(params, warmup=False)
    c = Client(app)
    st, r = c.post("/user_signup", json_body={
        "name": "u", "email": "u@x.com", "password": "p", "phone": ""})
    c.get(r["verify_url"])
    return c


def test_predict_http_roundtrip(client):
    st, r = client.post("/predict", files={"image": ("a.png", _png())})
    assert st == 200 and r["success"]
    for key in ("mask", "heatmap", "original"):
        img = Image.open(io.BytesIO(base64.b64decode(r[key])))
        assert img.size == (48, 40), key          # original size restored
    assert len(r["objectness_scores"]) == 4
    st, r = client.get("/test_connection")
    assert r["model"]["n_queries"] == 4 and r["model"]["compute_dtype"] == "float32"


def test_predict_refine_fails_cleanly(client):
    st, r = client.post("/predict?refine=1", files={"image": ("a.png", _png())})
    assert st == 500
    assert "bilateral solver" in str(r)
