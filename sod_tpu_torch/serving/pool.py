"""Multi-process serving of the port (twin of ``sod_tpu/serving/pool.py``):
pre-fork HTTP workers + one card-owning broker.

The reference serves everything from ONE Flask dev process
(``app.py:3926-3927``), so its ceiling is one Python interpreter.  The
``/predict`` host image pipeline (PIL decode, LANCZOS restore, PNG+base64
encode, the refinement's grid) is Python and numpy work that the GIL caps
near one core of a process.  The pool
(``python -m sod_tpu_torch.serving.app --workers N``) splits the two:

  parent process   — owns the card (the one CUDA context of the pool),
                     runs ``SelfMaskInference`` on ``--device`` +
                     ``InferenceBroker`` on a unix socket, and supervises
                     the workers (restarting crashed ones).
  worker processes — spawned fresh (never forked: a forked child would
                     inherit the parent's CUDA context), with no card
                     visible (``CUDA_VISIBLE_DEVICES`` empty).  Each runs
                     the FULL threaded WSGI app,
                     sharing the TCP port via ``SO_REUSEPORT`` (the
                     kernel load-balances connections), does all host
                     image work locally, the refinement's solve included
                     (on the CPU), and proxies only the resized
                     uint8 image / uint8 mask over the broker socket
                     (~150 KB in, ~50 KB out per request).

Cross-worker state: sessions are HMAC-signed cookies (``web.py:206``) so
any worker validates any login; users/images/subscriptions live in the
shared sqlite file; pending signups/OTPs and stub checkout sessions move
to DB-backed stores (``emailer.DbTokenStore``,
``payments.PaymentProvider(stub_store=db)``) because the in-memory ones
are per-process.  Concurrent broker requests from many workers feed the
parent's MicroBatcher exactly like concurrent threads did.

Differences from ``sod_tpu``'s pool, and only these: workers hide the card
through ``CUDA_VISIBLE_DEVICES`` where ``sod_tpu``'s pin jax to its CPU
backend; the parent's service is the port's ``SelfMaskInference`` on
``device``; there is no compile cache.
"""
from __future__ import annotations

import collections
import os
import pickle
import queue
import socket
import struct
import threading
import time
from types import SimpleNamespace
from typing import Any, Optional, Tuple

import numpy as np

from sod_tpu_torch.serving.inference import PredictPipeline

# 64 MB: far above any legitimate message (a 224px uint8 image is
# ~150 KB) but bounds a corrupt/hostile length prefix
_MAX_MSG = 64 << 20


# ---------------------------------------------------------------------------
# framing: 4-byte big-endian length + pickle
# ---------------------------------------------------------------------------
def _send_msg(conn: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(conn: socket.socket) -> Any:
    (n,) = struct.unpack(">I", _recv_exact(conn, 4))
    if n > _MAX_MSG:
        raise ConnectionError(f"oversized message ({n} bytes)")
    return pickle.loads(_recv_exact(conn, n))


# ---------------------------------------------------------------------------
# broker (parent process)
# ---------------------------------------------------------------------------
class InferenceBroker:
    """Serves ``model_step`` over a unix socket: one accept loop, one
    thread per worker connection (workers hold thread-local persistent
    connections, so the thread count tracks worker HTTP threads, and
    concurrent requests co-arrive at the MicroBatcher as intended)."""

    def __init__(self, svc, path: str):
        self.svc = svc
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # the socket runs arbitrary pickle loads, so other local users
        # must never reach it — not even during the bind→chmod window.
        # Callers put the path inside a 0700 tempdir (broker_socket_path);
        # the umask guard makes the node itself 0600 from birth as
        # defense in depth.
        old_umask = os.umask(0o077)
        try:
            self._sock.bind(path)
        finally:
            os.umask(old_umask)
        os.chmod(path, 0o600)
        self._sock.listen(128)
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="broker-accept")
        self._thread.start()

    def info(self) -> dict:
        cfg = self.svc.cfg
        return {
            "eval_image_size": cfg.eval_image_size,
            "arch": cfg.arch,
            "quantize": getattr(cfg, "quantize", "none"),
            "compute_dtype": cfg.compute_dtype,
            "n_queries": self.svc.mcfg.n_queries,
            "micro_batching": bool(self.svc.micro_batching),
            "broker_pid": os.getpid(),
        }

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                       # socket closed by close()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="broker-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            if self._stop.is_set():       # raced close(): refuse
                conn.close()
                return
            self._conns.add(conn)
        try:
            self._serve_conn_loop(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_conn_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    op, arg = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError,
                        pickle.UnpicklingError, struct.error):
                    return
                try:
                    if op == "predict":
                        mask_u8, obj = self.svc.model_step(arg)
                        reply = ("ok", (np.ascontiguousarray(mask_u8),
                                        np.asarray(obj, np.float32)))
                    elif op == "info":
                        reply = ("ok", self.info())
                    elif op == "ping":
                        reply = ("ok", "pong")
                    else:
                        reply = ("err", f"unknown op {op!r}")
                except BaseException as e:  # noqa: BLE001 — per request
                    reply = ("err", f"{type(e).__name__}: {e}")
                try:
                    _send_msg(conn, reply)
                except OSError:
                    return

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        finally:
            # drop live worker connections too — their threads are
            # blocked in recv and would otherwise keep serving
            with self._conns_lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            if os.path.exists(self.path):
                os.unlink(self.path)


# ---------------------------------------------------------------------------
# worker-side inference proxy
# ---------------------------------------------------------------------------
class RemoteInference(PredictPipeline):
    """Drop-in for ``SelfMaskInference`` inside a worker: the host image
    pipeline runs locally (that's the point of the pool), only
    ``model_step`` crosses the broker socket.  Connections come from a
    small bounded pool (NOT thread-locals: the worker's ThreadingMixIn
    server spawns a fresh thread per HTTP request, so a thread-local
    "persistent" connection would really be per-request churn — one
    connect + one lingering broker thread per /predict).  One
    transparent retry on a broken pipe (broker restart)."""

    is_remote = True
    POOL_MAX = 16   # idle connections kept; excess are closed on check-in

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._pool: "queue.Queue[socket.socket]" = queue.Queue(self.POOL_MAX)
        info = self._call("info", None)
        self.info = info
        self.cfg = SimpleNamespace(
            eval_image_size=info["eval_image_size"], arch=info["arch"],
            quantize=info["quantize"], compute_dtype=info["compute_dtype"])
        self.mcfg = SimpleNamespace(n_queries=info["n_queries"])
        self.micro_batching = bool(info["micro_batching"])
        self.broker_pid = info["broker_pid"]
        self._batcher = None                 # API parity with the local svc

    def _checkout(self) -> socket.socket:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            c.connect(self.socket_path)
            return c

    def _checkin(self, c: socket.socket) -> None:
        try:
            self._pool.put_nowait(c)
        except queue.Full:
            try:
                c.close()
            except OSError:
                pass

    def _call(self, op: str, arg: Any, _retried: bool = False) -> Any:
        try:
            c = self._checkout()
        except OSError as e:
            raise RuntimeError(
                f"inference broker unavailable at {self.socket_path}: "
                f"{e}") from e
        try:
            _send_msg(c, (op, arg))
            status, val = _recv_msg(c)
        except (ConnectionError, OSError, EOFError) as e:
            try:
                c.close()
            except OSError:
                pass
            if _retried:
                raise RuntimeError(
                    f"inference broker unavailable at {self.socket_path}: "
                    f"{e}") from e
            # a pooled socket may be stale (broker restarted while it sat
            # idle) — retry once on a fresh connection
            return self._call(op, arg, _retried=True)
        self._checkin(c)
        if status != "ok":
            raise RuntimeError(f"inference broker error: {val}")
        return val

    def model_step(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mask_u8, obj = self._call("predict", np.ascontiguousarray(arr))
        return mask_u8, obj


# ---------------------------------------------------------------------------
# worker process entry (must be a module-level function: spawn pickles it)
# ---------------------------------------------------------------------------
def _worker_main(port: int, socket_path: str, db_path: str, upload_dir: str,
                 secret_key: str, allow_default_admin: bool,
                 worker_index: int) -> None:
    # die with the parent no matter HOW it dies (SIGKILL included):
    # orphaned workers would keep the port bound and answer requests
    # with a dead broker behind them
    try:
        import ctypes
        import signal as _signal

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(
            PR_SET_PDEATHSIG, _signal.SIGTERM)
    except (OSError, AttributeError):    # non-Linux: supervisor cleanup only
        pass

    # NEVER touch the card from a worker: the parent holds the pool's one
    # CUDA context.  Importing torch (this module's import did) starts no
    # CUDA; the runtime reads this variable when something first calls
    # into torch.cuda, and then sees no device
    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    from sod_tpu_torch.serving.app import create_app
    from sod_tpu_torch.serving.db import Database
    from sod_tpu_torch.serving.emailer import DbTokenStore
    from sod_tpu_torch.serving.payments import PaymentProvider
    from sod_tpu_torch.serving.web import make_threaded_server

    db = Database(db_path)
    app = create_app(db=db, load_model=False, upload_dir=upload_dir,
                     secret_key=secret_key,
                     allow_default_admin=allow_default_admin,
                     tokens=DbTokenStore(db),
                     payments=PaymentProvider(stub_store=db))
    inference = None
    if socket_path:
        # mirror create_app's degrade-gracefully stance (ref
        # app.py:353-376): a worker that cannot reach the broker at boot
        # (restart race) still serves the product, answering /predict
        # with "Model not available" instead of crash-looping
        for attempt in range(3):
            try:
                inference = RemoteInference(socket_path)
                break
            except (RuntimeError, OSError) as e:
                print(f"[worker {worker_index}] broker connect failed "
                      f"(attempt {attempt + 1}/3): {e}", flush=True)
                time.sleep(1.0)
    app.inference = inference
    app.worker_index = worker_index
    srv = make_threaded_server("0.0.0.0", port, app, reuse_port=True)
    print(f"[worker {worker_index}] pid {os.getpid()} serving on :{port}",
          flush=True)
    srv.serve_forever()


def resolve_db_path() -> str:
    """The pool needs a FILE database every worker can open (the default
    in-memory sqlite is per-process)."""
    url = os.environ.get("SOD_DB_URL", "")
    if url.startswith("sqlite://"):
        path = url[len("sqlite://"):]
    elif url.startswith("mysql://"):
        raise NotImplementedError(
            "MySQL backend not supported (see serving/db.py)")
    else:
        path = os.environ.get("SOD_DB_PATH", "sod.db")
    if not path or path == ":memory:":
        raise ValueError(
            "--workers needs a file database shared by all worker "
            "processes; set SOD_DB_PATH (in-memory sqlite is per-process)")
    return path


def serve_pool(port: int, workers: int, cfg=None, device="cuda",
               model_path: Optional[str] = None, load_model: bool = True,
               allow_default_admin: bool = False,
               upload_dir: str = "static",
               max_restarts_per_worker: int = 5) -> None:  # pragma: no cover
    """Boot the pool and supervise it (blocks until SIGINT/SIGTERM)."""
    import multiprocessing as mp
    import signal
    import tempfile

    # a SIGTERM (systemd/k8s stop, plain `kill`) must run the cleanup
    # path, not orphan the workers on a still-bound port
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)

    db_path = resolve_db_path()
    secret = os.environ.get("SOD_SECRET_KEY")
    if not secret:
        import secrets as _secrets

        # one ephemeral key shared by ALL workers — per-worker keys would
        # bounce logins between workers
        secret = _secrets.token_hex(16)

    socket_path = ""
    broker = None
    socket_dir = None
    if load_model:
        from sod_tpu_torch.config import Config
        from sod_tpu_torch.serving.inference import SelfMaskInference

        svc = SelfMaskInference(model_path=model_path, cfg=cfg or Config(),
                                device=device)
        # a private 0700 directory (not bare /tmp): no other local user
        # can connect during the bind window or pre-plant/unlink the path
        socket_dir = tempfile.mkdtemp(prefix="sod-broker-")
        socket_path = os.path.join(socket_dir, "broker.sock")
        broker = InferenceBroker(svc, socket_path)

    ctx = mp.get_context("spawn")

    def spawn(i: int):
        p = ctx.Process(target=_worker_main,
                        args=(port, socket_path, db_path, upload_dir,
                              secret, allow_default_admin, i),
                        name=f"sod-worker-{i}")
        p.start()
        return p

    procs = {i: spawn(i) for i in range(workers)}
    print(f"serving on http://0.0.0.0:{port} with {workers} workers "
          f"(broker pid {os.getpid()}, db {db_path})", flush=True)
    # crash-loop guard: a SLIDING WINDOW, not a lifetime counter — a
    # worker that OOMs once a day over a long uptime must never add up
    # to a whole-pool shutdown.  Only a burst of restarts within the
    # window (a genuine crash loop) trips it.
    restart_window_sec = 300.0
    restart_times: collections.deque = collections.deque()
    try:
        while True:
            time.sleep(1.0)
            for i, p in list(procs.items()):
                if not p.is_alive():
                    now = time.monotonic()
                    restart_times.append(now)
                    while (restart_times and
                           now - restart_times[0] > restart_window_sec):
                        restart_times.popleft()
                    if len(restart_times) > max_restarts_per_worker * workers:
                        raise RuntimeError(
                            f"workers are crash-looping "
                            f"({len(restart_times)} restarts in "
                            f"{restart_window_sec:.0f}s); shutting down")
                    print(f"[pool] worker {i} (pid {p.pid}) exited with "
                          f"code {p.exitcode}; restarting", flush=True)
                    procs[i] = spawn(i)
    except KeyboardInterrupt:
        print("[pool] shutting down", flush=True)
    finally:
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.join(timeout=5)
        if broker is not None:
            broker.close()
        if socket_dir is not None:
            import shutil

            shutil.rmtree(socket_dir, ignore_errors=True)
