"""ctypes bindings for the native host codec (host/wgt_codec.cpp).

A copy of the JAX package's ``native.py``.  The library is compiled with
g++ at first use into ``webgraph_tpu_torch/build/``, under a name keyed by
a hash of the source, never next to the source (``csrc/`` holds the CUDA
sources that ``kernels/_build.py`` gives to nvcc).  All entry points
gracefully return None if no compiler is available, and callers fall back
to the pure-Python oracle paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "host", "wgt_codec.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_PU8 = ctypes.POINTER(ctypes.c_uint8)


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libwgt_codec_{key}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.wgt_decode_offsets.restype = _I64
        lib.wgt_decode_offsets.argtypes = [_PU8, _I64, _I64, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_I64)]
        lib.wgt_bvgraph_decode.restype = _I64
        lib.wgt_bvgraph_decode.argtypes = [_PU8, _I64, _I64, _I64] + [ctypes.c_int] * 8 + [
            ctypes.POINTER(_I64),
            ctypes.POINTER(_I32),
        ]
        lib.wgt_bvgraph_encode.restype = _I64
        lib.wgt_bvgraph_encode.argtypes = [ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I64] + [
            ctypes.c_int
        ] * 10 + [
            ctypes.POINTER(_PU8),
            ctypes.POINTER(_I64),
            ctypes.POINTER(_PU8),
            ctypes.POINTER(_I64),
            ctypes.POINTER(_I64),
        ]
        lib.wgt_bvgraph_encode_range.restype = _I64
        lib.wgt_bvgraph_encode_range.argtypes = [
            ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I64, _I64, ctypes.c_int
        ] + [ctypes.c_int] * 10 + [
            ctypes.POINTER(_PU8),
            ctypes.POINTER(_I64),
            ctypes.POINTER(_PU8),
            ctypes.POINTER(_I64),
            ctypes.POINTER(_I64),
        ]
        lib.wgt_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def decode_offsets(data: bytes, count: int, coding: int, k: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(count, dtype=np.int64)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    lib.wgt_decode_offsets(buf, len(data), count, coding, k, out.ctypes.data_as(ctypes.POINTER(_I64)))
    return out


def bvgraph_decode(data: bytes, n: int, m: int, settings) -> tuple[np.ndarray, np.ndarray] | None:
    lib = get_lib()
    if lib is None:
        return None
    out_off = np.zeros(n + 1, dtype=np.int64)
    out_succ = np.zeros(m, dtype=np.int32)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    arcs = lib.wgt_bvgraph_decode(
        buf,
        len(data),
        n,
        m,
        settings.window_size,
        settings.min_interval_length,
        settings.zeta_k,
        settings.outdegree_coding,
        settings.reference_coding,
        settings.block_coding,
        settings.block_count_coding,
        settings.residual_coding,
        out_off.ctypes.data_as(ctypes.POINTER(_I64)),
        out_succ.ctypes.data_as(ctypes.POINTER(_I32)),
    )
    if arcs != m:
        raise ValueError(f"native decode produced {arcs} arcs, expected {m}")
    return out_off, out_succ


def bvgraph_encode(offsets: np.ndarray, succ: np.ndarray, settings,
                   first_node: int = 0, skip_first_offset: bool = False):
    """Returns (graph_bytes, graph_bits, offsets_bytes, offsets_bits, stats)
    or None if the native library is unavailable.

    ``first_node``/``skip_first_offset`` encode a node-range SHARD: values
    anchor to global ids ``first_node + i`` and (for shards after the
    first) the leading offset delta is omitted so shard offset streams
    bit-concatenate exactly (reference thread-merge, BVGraph.java:2498-2550).
    The ctypes call releases the GIL, so shards parallelize on threads."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    succ = np.ascontiguousarray(succ, dtype=np.int32)
    n = len(offsets) - 1
    gp = _PU8()
    op = _PU8()
    gbits = _I64()
    obits = _I64()
    stats = np.zeros(76, dtype=np.int64)  # 10 counters + 2x33 gap histograms
    lib.wgt_bvgraph_encode_range(
        offsets.ctypes.data_as(ctypes.POINTER(_I64)),
        succ.ctypes.data_as(ctypes.POINTER(_I32)),
        n,
        first_node,
        1 if skip_first_offset else 0,
        settings.window_size,
        settings.max_ref_count,
        settings.min_interval_length,
        settings.zeta_k,
        settings.outdegree_coding,
        settings.reference_coding,
        settings.block_coding,
        settings.block_count_coding,
        settings.residual_coding,
        settings.offset_coding,
        ctypes.byref(gp),
        ctypes.byref(gbits),
        ctypes.byref(op),
        ctypes.byref(obits),
        stats.ctypes.data_as(ctypes.POINTER(_I64)),
    )
    graph_bytes = ctypes.string_at(gp, (gbits.value + 7) // 8)
    off_bytes = ctypes.string_at(op, (obits.value + 7) // 8)
    lib.wgt_free(gp)
    lib.wgt_free(op)
    return graph_bytes, gbits.value, off_bytes, obits.value, stats
