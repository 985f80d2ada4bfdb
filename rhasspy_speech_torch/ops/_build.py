"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library under
``csrc/build/`` (listed in ``.gitignore``), named by a hash of the source
and the flags, then loaded with ``ctypes``. Pointers cross as
``c_void_p``; every entry takes the caller's CUDA stream and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc runs in this process (utils/warmup.py reads it: a warm process
# compiles nothing on its first call)
nvcc_runs = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build kernels")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    exists; raises with nvcc's output when the build fails."""
    global nvcc_runs
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc_runs += 1
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built on first use.
    Every library also exports ``rss_error_string(int) -> const char*``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.rss_error_string.argtypes = [ctypes.c_int]
            lib.rss_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def loaded() -> Tuple[str, ...]:
    """Names of the kernel libraries this process has loaded."""
    with _LOCK:
        return tuple(sorted(_LIBS))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.rss_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
