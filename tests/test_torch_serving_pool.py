"""The port's serving pool (``sod_tpu_torch.serving.pool``), the mirror of
``tests/test_serving_pool.py``: the broker protocol, ``RemoteInference``
against the in-process service it proxies (byte-equal payloads, the
refinement included: both solve on the CPU here), and one real two-worker
``SO_REUSEPORT`` HTTP drive.  The in-process service is the port's
``SelfMaskInference`` on the CPU with a tiny model and seeded weights.

``tests/test_serving_pool.py``'s DB-backed store tests are not repeated:
``serving/{db,emailer,payments}.py`` are ``sod_tpu``'s files, held equal to
them by ``tests/test_torch_no_jax_package.py``."""
import io
import json
import multiprocessing as mp
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.serving import app as port_app
from sod_tpu_torch.serving import inference as port_inference
from sod_tpu_torch.serving import pool
from sod_tpu_torch.serving.db import Database
from sod_tpu_torch.serving.pool import InferenceBroker, RemoteInference, _worker_main

TCFG = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
    patch_size=8, embed_dim=32, depth=2, n_heads=2, pos_grid=4))


def _tiny_inference():
    cfg = Config(eval_image_size=32, compute_dtype="float32", micro_batch=False)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(port_inference, "config_from", lambda cfg: TCFG)
        return port_inference.SelfMaskInference(
            cfg=cfg, state_dict=random_state_dict(MaskFormer(TCFG), 0), device="cpu",
            warmup=False)


def _png(h=40, w=48):
    img = np.full((h, w, 3), 25, np.uint8)
    img[10:30, 12:40] = 210
    img[14:18, 20:24] = 90
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def broker_env(tmp_path_factory):
    svc = _tiny_inference()
    path = str(tmp_path_factory.mktemp("brk") / "broker.sock")
    broker = InferenceBroker(svc, path)
    yield svc, path
    broker.close()


def test_remote_predict_bit_exact(broker_env):
    svc, path = broker_env
    remote = RemoteInference(path)
    png = _png()
    # identical model + identical host pipeline -> byte-identical payload
    assert remote.predict(png) == svc.predict(png)
    # the refine path (bilateral solver) runs worker-side, on the CPU
    refined = remote.predict(png, refine=True)
    assert {"refined_mask", "binary_mask"} <= set(refined)
    assert refined == svc.predict(png, refine=True)
    assert str(remote.device) == "cpu"


def test_remote_info_surface(broker_env):
    svc, path = broker_env
    remote = RemoteInference(path)
    assert remote.cfg.eval_image_size == svc.cfg.eval_image_size
    assert remote.cfg.quantize == "none" and remote.cfg.compute_dtype == "float32"
    assert remote.mcfg.n_queries == svc.mcfg.n_queries == 4
    assert remote.is_remote and remote.broker_pid == remote.info["broker_pid"]
    assert isinstance(remote.broker_pid, int) and not remote.micro_batching


def test_remote_concurrent_clients(broker_env):
    svc, path = broker_env
    png = _png()
    expect = svc.predict(png)
    remote = RemoteInference(path)
    results = [None] * 8

    def worker(i):
        for _ in range(3):
            results[i] = remote.predict(png)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r == expect for r in results)


def test_broker_error_keeps_connection(broker_env):
    _, path = broker_env
    remote = RemoteInference(path)
    with pytest.raises(RuntimeError, match="unknown op"):
        remote._call("bogus", None)
    # a per-request error must not poison the persistent connection
    assert remote._call("ping", None) == "pong"


def test_remote_reconnects_after_drop(broker_env):
    svc, path = broker_env
    remote = RemoteInference(path)
    png = _png()
    assert remote.predict(png) == svc.predict(png)
    # a broken pipe on every pooled connection (broker restart while the
    # sockets sat idle in the pool)
    while not remote._pool.empty():
        remote._pool.get_nowait().close()
    assert remote.predict(png) == svc.predict(png)


def test_remote_pool_reuses_connections(broker_env):
    _, path = broker_env
    remote = RemoteInference(path)
    for _ in range(5):
        assert remote._call("ping", None) == "pong"
    # sequential calls from one thread reuse ONE pooled socket
    assert remote._pool.qsize() == 1


def test_remote_raises_when_broker_gone(tmp_path):
    svc = _tiny_inference()
    path = str(tmp_path / "b.sock")
    broker = InferenceBroker(svc, path)
    remote = RemoteInference(path)
    broker.close()
    with pytest.raises(RuntimeError, match="broker unavailable"):
        remote.model_step(np.zeros((32, 32, 3), np.uint8))


def test_pool_needs_a_file_database(monkeypatch, tmp_path):
    monkeypatch.delenv("SOD_DB_URL", raising=False)
    monkeypatch.setenv("SOD_DB_PATH", ":memory:")
    with pytest.raises(ValueError, match="SOD_DB_PATH"):
        pool.resolve_db_path()
    monkeypatch.setenv("SOD_DB_PATH", str(tmp_path / "pool.db"))
    assert pool.resolve_db_path() == str(tmp_path / "pool.db")


@pytest.mark.parametrize("argv,want", [
    (["--workers", "2", "--device", "cpu", "--quantize", "int8"],
     dict(workers=2, device="cpu", load_model=True, quantize="int8")),
    (["--workers", "3", "--no-model"],
     dict(workers=3, device="cuda", load_model=False, quantize="none"))])
def test_app_main_boots_the_pool_for_workers(monkeypatch, argv, want):
    """``--workers N`` > 1 hands the port, the device, the config (with
    ``--quantize``) and ``--no-model`` to ``serve_pool``; no service is
    built in-process."""
    seen = {}

    def serve_pool(**kw):
        seen.update(kw)

    class _Never:
        def __init__(self, **kw):
            raise AssertionError("pool mode builds the service in serve_pool")

    monkeypatch.setattr(pool, "serve_pool", serve_pool)
    monkeypatch.setattr(port_inference, "SelfMaskInference", _Never)
    port_app.main(["--port", "0", *argv])
    assert seen["workers"] == want["workers"] and seen["device"] == want["device"]
    assert seen["load_model"] == want["load_model"]
    assert seen["cfg"].quantize == want["quantize"] and seen["port"] == 0


# ---------------------------------------------------------------------------
# 2-worker SO_REUSEPORT end-to-end over real HTTP
# ---------------------------------------------------------------------------
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _multipart(field, filename, data):
    bound = "sodpoolbound42"
    body = (
        f"--{bound}\r\nContent-Disposition: form-data; "
        f'name="{field}"; filename="{filename}"\r\n'
        f"Content-Type: image/png\r\n\r\n").encode() + data + \
        f"\r\n--{bound}--\r\n".encode()
    return body, f"multipart/form-data; boundary={bound}"


def test_pool_http_end_to_end(tmp_path):
    """The product flow against two REAL spawned worker processes sharing
    one port, the model served over the broker from THIS process: signup
    and verify on any worker, six ``/predict`` (two with ``refine=1``),
    every payload equal to the in-process service's."""
    svc = _tiny_inference()
    sock_path = str(tmp_path / "broker.sock")
    broker = InferenceBroker(svc, sock_path)
    db_path = str(tmp_path / "pool.db")
    Database(db_path)                    # create the schema once up front
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_worker_main,
                    args=(port, sock_path, db_path,
                          str(tmp_path / "static"), "pool-secret", False, i),
                    name=f"test-worker-{i}")
        for i in range(2)
    ]
    for p in procs:
        p.start()

    base = f"http://127.0.0.1:{port}"
    opener = urllib.request.build_opener(urllib.request.HTTPCookieProcessor())

    def req(path, data=None, headers=None, timeout=60):
        r = urllib.request.Request(base + path, data=data, headers=headers or {})
        with opener.open(r, timeout=timeout) as resp:
            return json.loads(resp.read())

    try:
        # readiness: BOTH workers answer (REUSEPORT hashes the 4-tuple;
        # fresh client ports spread across them)
        pids = set()
        deadline = time.time() + 180
        while len(pids) < 2 and time.time() < deadline:
            try:
                info = req("/test_connection", timeout=5)
                pids.add(info["pid"])
                assert info["model"]["broker_pid"] == broker.info()["broker_pid"]
            except (OSError, json.JSONDecodeError):
                time.sleep(0.5)
        assert len(pids) == 2, f"saw worker pids {pids}"

        r = req("/user_signup",
                data=json.dumps({"name": "u", "email": "u@x.com",
                                 "password": "p", "phone": ""}).encode(),
                headers={"Content-Type": "application/json"})
        assert "verify_url" in r
        assert req(r["verify_url"]).get("success")

        expect = {False: svc.predict(_png()), True: svc.predict(_png(), refine=True)}
        for i in range(6):
            refine = i in (1, 4)
            body, ctype = _multipart("image", "a.png", _png())
            r = req("/predict" + ("?refine=1" if refine else ""), data=body,
                    headers={"Content-Type": ctype})
            assert r.pop("success")
            assert r == expect[refine]
        assert req("/test_connection")["pid"] in pids
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10)
        broker.close()
    assert not any(p.is_alive() for p in procs)
