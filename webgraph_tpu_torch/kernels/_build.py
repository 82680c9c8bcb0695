"""Build the port's CUDA sources into one shared library at first use.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a shared library with a
plain C interface, which ``ctypes`` loads; nothing includes PyTorch's
headers, so a build takes seconds.  The library lands in
``webgraph_tpu_torch/build/`` under a name keyed by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.

Importing this module needs no CUDA toolkit: only :func:`load` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("decode2.cu",)
HEADERS = ("pcodes.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points of csrc/decode2.cu: every pointer and the stream as void*
_SIGNATURES = {
    # words, nbits, pos, b, n, coding, k, val, len, stream
    "wgt_k0_probe": (_P, _L, _P, _P, _I, _I, _I, _P, _P, _P),
    # words, nbits, bo, gid0, gid0b, cnt, cnta, d7, d7b, lanes, slabw,
    # outd, ref, bcnt, blk, res, zeta_k, window, minint, slab, wp, err, stream
    "wgt_k1_decode2": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (set CUDA_HOME)")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwgt_torch_{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call and then cached."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
