"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``sod_tpu_torch/_build/`` (git-ignored), named by a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source rebuilds and an unchanged one loads the cached library.
Different libraries build concurrently (one lock per name).  Delete
``_build/`` to force a rebuild.  ``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``,
else ``/usr/local/cuda/bin/nvcc``.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_build_locks: dict = {}                # name -> lock: one build per library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it.

    Raises ``RuntimeError`` with nvcc's output when the build fails.  The
    compiler's report (registers, shared memory, spills per kernel) is kept
    beside the library as ``<library>.log``."""
    so = library_path(name)
    with _build_locks.setdefault(name, threading.Lock()):
        if not os.path.exists(so):
            _compile(name, so)
    return ctypes.CDLL(so)


def _compile(name: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): cannot build {name}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(f"{so}.log", "w") as f:
        f.write(f"{' '.join(cmd)}\nbuilt in {time.perf_counter() - t0:.2f} s\n"
                f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)         # atomic: another process loads all or nothing
