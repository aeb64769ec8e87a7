"""The port's ``/predict`` service (``sod_tpu_torch.serving.inference``)
against ``sod_tpu``'s ``SelfMaskInference`` on the same tiny weights, the
micro-batcher, and an HTTP round trip through the port's web app
(``sod_tpu_torch.serving.app``, its own copy of ``sod_tpu``'s).

Both services run f32 here (``sod_tpu`` off the TPU takes its unfused
path): masks agree within one uint8 level, objectness within 1e-5.

The int8 service (``Config.quantize = "int8"``, bf16) at 64 px against
``sod_tpu``'s int8 forward, routed on the CPU by patching ``fused_available``
and running K8 in interpret mode, compiled with XLA's excess precision off:
the selected masks and the objectness within 2e-3 (sigmoids; f32 noise plus
rare int8 code flips, see ``tests/test_torch_fused_block_int8.py``).
"""
import base64
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sod_tpu.ops.fused_block as jax_fused_block
import sod_tpu.ops.fused_block_int8 as jax_int8

from sod_tpu.config import Config
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_apply, maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu.serving.inference import SelfMaskInference as JaxInference
from sod_tpu_torch.models.convert import blocks_q_from_jax, state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.serving import inference as port_inference
from sod_tpu_torch.serving import app as port_app
from sod_tpu_torch.serving.app import create_app
from sod_tpu_torch.serving.db import Database
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


def _int8_cfg(**kw):
    return Config(eval_image_size=64, compute_dtype="bfloat16", micro_batch=False,
                  quantize="int8", **kw)


def test_int8_service_quantises_the_pre_cast_weights(params):
    svc = _port(params, cfg=_int8_cfg(), warmup=False)
    theirs = JaxInference(cfg=_int8_cfg(), params=params, warmup=False)
    records = svc.model.encoder.blocks_q
    carried = blocks_q_from_jax(jax.tree.map(np.asarray,
                                             theirs.params["encoder"]["blocks_q"]))
    assert len(records) == len(carried) == VIT["depth"]
    assert next(svc.model.parameters()).dtype == torch.bfloat16
    for ours, ref in zip(records, carried):
        assert ours["qkv"]["q"].dtype == torch.int8
        for name in ours:
            for leaf, t in ours[name].items():
                assert t.dtype == (torch.int8 if leaf == "q" else torch.float32)
                assert torch.equal(t, ref[name][leaf]), (name, leaf)
    # f32 LayerNorm parameters that the bf16 cast would have rounded
    w = np.asarray(params["encoder"]["blocks"]["attn"]["qkv"]["w"][0]).T
    assert np.array_equal(records[0]["qkv"]["s"].numpy(),
                          np.maximum(np.abs(w).max(1) / np.float32(127), 1e-12))


def test_int8_service_matches_sod_tpus_int8_forward(params, rng, monkeypatch):
    monkeypatch.setattr(jax_fused_block, "fused_available", lambda: True)
    real = jax_int8.fused_vit_block_int8
    calls = []

    def interp(*a, **kw):
        calls.append(1)
        return real(*a, interpret=True, **kw)

    monkeypatch.setattr(jax_int8, "fused_vit_block_int8", interp)
    theirs = JaxInference(cfg=_int8_cfg(), params=params, warmup=False)
    u8 = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)

    def forward(p, x):
        out = maskformer_apply(p, x, JCFG, fused=True)
        obj = out["objectness"][:, -1, :, 0]
        best = jnp.argmax(obj, axis=-1)
        sel = jnp.take_along_axis(out["mask_pred"][:, -1],
                                  best[:, None, None, None], axis=1)[:, 0]
        return sel.astype(jnp.float32), obj.astype(jnp.float32)

    x = theirs._prep(jnp.asarray(u8))
    m2, o2 = jax.jit(forward).lower(theirs.params, x).compile(
        compiler_options={"xla_allow_excess_precision": False})(theirs.params, x)
    assert len(calls) == 1                      # one scan body: K8 was routed

    ours = _port(params, cfg=_int8_cfg(), warmup=False)
    m1, o1 = ours.forward_u8(u8)
    assert m1.shape == (2, 16, 16) and o1.shape == (2, 4)
    np.testing.assert_allclose(o1.numpy(), np.asarray(o2), atol=2e-3, rtol=0)
    np.testing.assert_allclose(m1.numpy(), np.asarray(m2), atol=2e-3, rtol=0)
    # and the int8 path is not the bf16 one
    plain = _port(params, cfg=_int8_cfg().replace(quantize="none"), warmup=False)
    assert not torch.equal(plain.forward_u8(u8)[0], m1)
    mask, obj = ours.model_step(u8[0])
    assert mask.dtype == np.uint8 and mask.shape == (16, 16) and obj.shape == (4,)


def test_int8_service_refuses_resnet50(params):
    with pytest.raises(ValueError, match="resnet50"):
        _port(params, cfg=_int8_cfg(arch="resnet50"), warmup=False)


@pytest.mark.parametrize("argv,want", [
    (["--quantize", "int8", "--device", "cpu"], "int8"),
    (["--quantize", "none", "--device", "cpu"], "none"),
    (["--device", "cpu"], "none")])
def test_app_main_takes_quantize(monkeypatch, argv, want):
    seen = {}

    class _Svc:
        def __init__(self, **kw):
            seen.update(kw)

    class _Stop(Exception):
        pass

    def no_server(*a, **kw):
        raise _Stop

    monkeypatch.setattr(port_inference, "SelfMaskInference", _Svc)
    monkeypatch.setattr("sod_tpu_torch.serving.web.make_threaded_server", no_server)
    with pytest.raises(_Stop):
        port_app.main(argv)
    assert seen["cfg"].quantize == want and seen["device"] == "cpu"


def test_test_connection_reports_quantize(params, tmp_path):
    app = create_app(db=Database(":memory:"), load_model=False,
                     upload_dir=str(tmp_path / "static"), secret_key="t")
    app.inference = _port(params, cfg=_int8_cfg(), warmup=False)
    st, r = Client(app).get("/test_connection")
    assert st == 200 and r["model"]["quantize"] == "int8"


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


def test_predict_refine_fails_cleanly(client, monkeypatch):
    """A refinement that raises answers a 500 with the error, not a broken
    connection (until ROADMAP item 10 every ``refine=1`` did: the solver was
    not ported)."""
    import sod_tpu_torch.postprocess as post

    def broken(*a, **kw):
        raise RuntimeError("bilateral solver failed")

    monkeypatch.setattr(post, "bilateral_solver_output", broken)
    st, r = client.post("/predict?refine=1", files={"image": ("a.png", _png())})
    assert st == 500
    assert "bilateral solver" in str(r)


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))), np.int32)


def test_predict_refine_matches_sod_tpu(client, params, tmp_path):
    """``/predict?refine=1`` answers 200 with ``refined_mask`` and
    ``binary_mask`` at the upload's size, against ``sod_tpu``'s pipeline on
    the same weights: the decoded refined mask within one uint8 level, the
    binary mask equal wherever ``sod_tpu``'s refined mask is more than one
    level from 127.5 (its 0.5 band)."""
    st, r = client.post("/predict?refine=1", files={"image": ("a.png", _png())})
    assert st == 200 and r["success"]
    theirs = _sod_tpu(params).predict(_png(), refine=True)
    for key in ("refined_mask", "binary_mask"):
        assert _decode(r[key]).shape == (40, 48), key
    soft, soft_j = _decode(r["refined_mask"]), _decode(theirs["refined_mask"])
    assert np.abs(soft - soft_j).max() <= 1
    off_band = np.abs(soft_j - 127.5) > 1
    binary, binary_j = _decode(r["binary_mask"]), _decode(theirs["binary_mask"])
    assert np.array_equal(binary[off_band], binary_j[off_band])
    assert set(np.unique(binary)) <= {0, 255}
