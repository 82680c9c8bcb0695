"""The benchmark's frozen BVGraph encoder and store, behind its own ctypes
binding.

``bvencode.cpp`` beside this file is compiled with g++ at first use into
``benchmark/build/`` under a name keyed by a hash of the source, so that
only the first run in a checkout builds it.  :func:`encode` gives the
``.graph`` and ``.offsets`` bytes of a CSR; :func:`store` writes them with
a ``.properties`` file that the port's ``BVGraph.load`` reads.

Imports nothing of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "bvencode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build")

# instantaneous codes, as BVGraph's compression flags name them
CODES = {"DELTA": 1, "GAMMA": 2, "GOLOMB": 3, "UNARY": 5, "ZETA": 6,
         "NIBBLE": 7}
# BVGraph's default code of each component (BVGraph.java:474-544), which a
# .properties file leaves out of its compression flags
DEFAULT_CODINGS = {"OUTDEGREES": "GAMMA", "BLOCKS": "GAMMA",
                   "RESIDUALS": "ZETA", "REFERENCES": "UNARY",
                   "BLOCK_COUNT": "GAMMA", "OFFSETS": "GAMMA"}

_I64 = ctypes.c_int64
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_lib = None


def _load():
    global _lib
    if _lib is None:
        with open(SRC, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libbvencode_{key}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.bench_bvgraph_encode.restype = _I64
        lib.bench_bvgraph_encode.argtypes = (
            [ctypes.POINTER(_I64), ctypes.POINTER(ctypes.c_int32), _I64]
            + [ctypes.c_int] * 10
            + [ctypes.POINTER(_PU8), ctypes.POINTER(_I64),
               ctypes.POINTER(_PU8), ctypes.POINTER(_I64),
               ctypes.POINTER(_I64)])
        lib.bench_free.argtypes = [ctypes.c_void_p]
        lib.bench_free.restype = None
        _lib = lib
    return _lib


def codings(store: dict) -> dict:
    """The code number of each component under a configuration's ``store``
    entry (its ``codings``, each component defaulting to BVGraph's)."""
    names = dict(DEFAULT_CODINGS, **store.get("codings", {}))
    return {k: CODES[v] for k, v in names.items()}


def encode(offsets, succ, store: dict, stats=None):
    """``(graph_bytes, graph_bits, offsets_bytes, offsets_bits)`` of the CSR
    ``(offsets int64[n+1], succ int32[m])`` under ``store`` (window_size,
    max_ref_count, min_interval_length, zeta_k and optional codings).
    ``stats``: an int64[76] array that the encoder's counts are added to
    (bits by component, then arcs copied, in intervals and residual, the
    sum of chain depths and of reference distances, and two histograms)."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    succ = np.ascontiguousarray(succ, dtype=np.int32)
    c = codings(store)
    gp, op = _PU8(), _PU8()
    gbits, obits = _I64(), _I64()
    if stats is None:
        stats = np.zeros(76, dtype=np.int64)
    lib.bench_bvgraph_encode(
        offsets.ctypes.data_as(ctypes.POINTER(_I64)),
        succ.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(offsets) - 1,
        int(store["window_size"]), int(store["max_ref_count"]),
        int(store["min_interval_length"]), int(store["zeta_k"]),
        c["OUTDEGREES"], c["REFERENCES"], c["BLOCKS"], c["BLOCK_COUNT"],
        c["RESIDUALS"], c["OFFSETS"],
        ctypes.byref(gp), ctypes.byref(gbits), ctypes.byref(op),
        ctypes.byref(obits), stats.ctypes.data_as(ctypes.POINTER(_I64)))
    try:
        graph_bytes = ctypes.string_at(gp, (gbits.value + 7) // 8)
        off_bytes = ctypes.string_at(op, (obits.value + 7) // 8)
    finally:
        lib.bench_free(gp)
        lib.bench_free(op)
    return graph_bytes, gbits.value, off_bytes, obits.value


def statistics(offsets, succ, store: dict) -> dict:
    """What a BVGraph ``.properties`` file states of the CSR stored under
    ``store``: ``arcs``, ``bitsperlink`` (graph bits an arc), ``avgref``
    (the mean reference chain depth a node) and ``avgdist`` (the mean
    reference distance a node), as ``BVGraph.store`` computes them."""
    st = np.zeros(76, dtype=np.int64)
    _, gbits, _, _ = encode(offsets, succ, store, st)
    n, m = len(offsets) - 1, int(offsets[-1])
    return {"arcs": m, "bitsperlink": gbits / max(m, 1),
            "avgref": int(st[8]) / max(n, 1),
            "avgdist": int(st[9]) / max(n, 1)}


def store(basename: str, offsets, succ, store: dict) -> dict:
    """Write ``basename.graph``, ``.offsets`` and ``.properties``; returns
    the sizes: ``{"nodes", "arcs", "graph_bytes", "offsets_bytes"}``."""
    gb, gbits, ob, obits = encode(offsets, succ, store)
    with open(basename + ".graph", "wb") as f:
        f.write(gb)
    with open(basename + ".offsets", "wb") as f:
        f.write(ob)
    n, m = len(offsets) - 1, int(offsets[-1])
    names = dict(DEFAULT_CODINGS, **store.get("codings", {}))
    flags = " | ".join(f"{k}_{v}" for k, v in names.items()
                       if v != DEFAULT_CODINGS[k])
    props = {"version": 0, "graphclass": "it.unimi.dsi.webgraph.BVGraph",
             "nodes": n, "arcs": m,
             "windowsize": store["window_size"],
             "maxrefcount": store["max_ref_count"],
             "minintervallength": store["min_interval_length"],
             "zetak": store["zeta_k"], "compressionflags": flags,
             "graphbits": gbits, "offsetbits": obits}
    with open(basename + ".properties", "w") as f:
        f.write("#BVGraph properties\n")
        f.writelines(f"{k}={v}\n" for k, v in props.items())
    return {"nodes": n, "arcs": m, "graph_bytes": len(gb),
            "offsets_bytes": len(ob)}
