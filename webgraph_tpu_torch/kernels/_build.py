"""Build the port's CUDA sources into shared libraries at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into a shared library
of its own with a plain C interface, which ``ctypes`` loads; nothing
includes PyTorch's headers, so a build takes seconds, and the sources are
compiled in parallel, one ``nvcc`` each.  The libraries land in
``webgraph_tpu_torch/build/`` under names keyed by a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  ``ptxas -v``'s report (registers, stack and
spills of each kernel) is kept beside each library; :func:`registers`
reads it.

Importing this module needs no CUDA toolkit: only :func:`load` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
HEADERS = ("pcodes.cuh", "records.cuh", "wcodes.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
# C entry points of each source: every pointer and the stream as void*
_SIGNATURES = {
    "decode2.cu": {
        # words, nbits, pos, b, n, coding, k, val, len, stream
        "wgt_k0_probe": (_P, _L, _P, _P, _I, _I, _I, _P, _P, _P),
        # words, nbits, bo, offsets, order, bstart, n, b1, long, nlong,
        # outd, ref, bcnt, blk, res, zeta_k, window, minint,
        # ext, bend, rank, ref, nex, flags, succ, err,
        # launched (host int[1]), stream
        "wgt_k1_parse": (_P, _L, _P, _P, _P, _P, _L, _L, _P, _L,
                         _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    },
    "decode.cu": {
        # words, nbits, bo, offsets, order, bstart, n, b1,
        # outd, ref, bcnt, blk, res, zeta_k, window, minint,
        # ext, bend, rank, ref, nex, flags, ticket, succ, err, resolve,
        # launched (host int[2]), stream
        "wgt_k2_decode": (_P, _L, _P, _P, _P, _P, _L, _L,
                          _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P),
        # offsets, order, b1, n, bstart, bend, ext, rank, ref, nex, flags,
        # ticket, succ, err, launched (host int[1]), stream
        "wgt_k2_resolve": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P),
        # vals, cnt, qpos, lanes, depth, pool, q, stream
        "wgt_k2_compact_probe": (_P, _P, _P, _I, _I, _P, _P, _P),
    },
    "propagate.cu": {
        # in_src, order, bounds, span, n, k, in, a, b, stat, perbit, dist,
        # level0, cap, stream
        "wgt_or_pull": (_P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _I, _P, _I,
                        _I, _P),
        # perbit
        "wgt_or_pull_blocks": (_I,),
    },
    "hyperball.cu": {
        # succ, order, bounds, span, n, log2m, in, a, b, fin, fa, fb, cur,
        # w, sod, soi, disc, nd, factors, alpha_mm, mod0, nf0, thr,
        # systolic, sys_thr, it0, cap, stat, stream
        "wgt_hll_pull": (_P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _I, _P, _D, _L, _D, _D,
                         _I, _D, _I, _I, _P, _P),
        # log2m
        "wgt_hll_pull_blocks": (_I,),
    },
    "encode.cu": {
        # off, succ, n, outd, ref, bcnt, blk, res, zeta_k, window, minint,
        # shard_start, costs, valid, stream
        "wgt_enc_costs": (_P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                          _P, _P, _P),
        # costs, valid, n, window, maxref, refs, depths, scratch,
        # scratch words, stream
        "wgt_enc_select": (_P, _P, _L, _I, _L, _P, _P, _P, _L, _P),
        # off, succ, refs, depths, starts, n, outd, ref, bcnt, blk, res,
        # zeta_k, window, minint, words, opos, offset coding, owords, stats,
        # stream
        "wgt_enc_emit": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _I, _P, _P, _P),
    },
    "probes.cu": {
        # words, nbits, starts, lanes, k, coding, zeta_k, out, stream
        "wgt_probe_winmach": (_P, _L, _P, _I, _I, _I, _I, _P, _P),
        # x, trips, out, stream
        "wgt_probe_relayout": (_P, _I, _P, _P),
        # x, trips, out, wq, colbuf, stream
        "wgt_probe_merge_trip": (_P, _I, _P, _P, _P, _P),
        # pages, p8, x, reps, out, stream
        "wgt_probe_refill": (_P, _I, _P, _I, _P, _P),
        # x, pre, r, reps, colT, pool, out, stream
        "wgt_probe_compaction": (_P, _P, _I, _I, _P, _P, _P, _P),
        # pages, np, x, reps, out, chk, stream
        "wgt_probe_page_fetch": (_P, _I, _P, _I, _P, _P, _P),
        # pos, lanes, pool, rows, k, out, stream
        "wgt_probe_fetch": (_P, _I, _P, _I, _I, _P, _P),
        # planes, r, idx, n, out, stream
        "wgt_probe_row_gather": (_P, _I, _P, _I, _P, _P),
    },
    "loops.cu": {
        # x, flags, rounds, trips, slab, out, wq, colbuf, stream
        "wgt_probe_lane_loop": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
        # tbl, rows, cols, mode, carry0, reps, nstage, out, chk, stream
        "wgt_probe_gather_loop": (_P, _I, _I, _I, _P, _I, _I, _P, _P, _P),
        # a, b, m, k, n, onehot, reps, out, chk, stream
        "wgt_probe_dot_loop": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
        # pages, rows, mode, carry0, reps, nstage, out, chk, stream
        "wgt_probe_plane_refill": (_P, _I, _I, _P, _I, _I, _P, _P, _P),
        # x, t_rows, addc, reps, xt, out, chk, stream
        "wgt_probe_transpose_loop": (_P, _I, _I, _I, _P, _P, _P, _P),
        # x, rows, reps, out, chk, stream
        "wgt_probe_copy_loop": (_P, _I, _I, _P, _P, _P),
        # x, reps, out, chk, stream
        "wgt_probe_stack_fetch": (_P, _I, _P, _P, _P),
        # x, pre, stage, reps, colT, pool, out, chk, stream
        "wgt_probe_jframe": (_P, _P, _I, _I, _P, _P, _P, _P, _P),
        # w, salt, trips, out, state, stream
        "wgt_probe_v6_trip": (_P, _P, _I, _P, _P, _P),
        # planes, r0, slab, idx, salt, call, r, stream
        "wgt_probe_v6_fetch": (_P, _P, _P, _P, _P, _I, _P, _P),
        # x, salt, mode, reps, out, chk, stream
        "wgt_probe_body_loop": (_P, _P, _I, _I, _P, _P, _P),
    },
    "forms.cu": {
        # tbl, rows, cols, idx, irows, icols, axis, out, stream
        "wgt_probe_form_gather": (_P, _I, _I, _P, _I, _I, _I, _P, _P),
        # x, rows, cols, mode, width, col, n_out, out, stream
        "wgt_probe_form_relayout": (_P, _I, _I, _I, _I, _I, _L, _P, _P),
        # x, rows, cols, shift, mode, out, stream
        "wgt_probe_form_roll": (_P, _I, _I, _P, _I, _P, _P),
        # a, b, m, k, n, dtype, trans_a, out, stream
        "wgt_probe_form_dot": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
        # src, idx, nsrc, rows, mode, out, stream
        "wgt_probe_form_onehot": (_P, _P, _I, _I, _I, _P, _P),
        # src, src_rows, offs, mode, blocks, dst, dst_rows, stream
        "wgt_probe_form_copy": (_P, _I, _P, _I, _I, _P, _I, _P),
        # x, n, mode, trips, out, cnt, stream
        "wgt_probe_form_scalar": (_P, _I, _I, _I, _P, _P, _P),
    },
}
SOURCES = tuple(_SIGNATURES)

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None


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


def library_path(source: str) -> str:
    """Where the library of ``source`` (a name in :data:`SOURCES`) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libwgt_{stem}_{h.hexdigest()[:16]}.so")


def _compile(todo: dict) -> None:
    """Run one nvcc per source, all at once: ``todo`` maps source to .so."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    try:
        for src, so, tmp, proc in procs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{err}")
            else:
                with open(so + ".ptxas", "w") as f:
                    f.write(err)
                os.replace(tmp, so)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def load() -> types.SimpleNamespace:
    """The kernels' C entry points by name, compiled on first call and then
    cached."""
    global _lib
    with _lock:
        if _lib is None:
            paths = {src: library_path(src) for src in SOURCES}
            todo = {s: p for s, p in paths.items() if not os.path.exists(p)}
            if todo:
                _compile(todo)
            fns = {}
            for src, path in paths.items():
                lib = ctypes.CDLL(path)
                for name, argtypes in _SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def registers(source: str, kernels) -> dict:
    """Registers of each of ``kernels`` (names of ``__global__`` functions
    of ``source``) as ``ptxas -v`` reported them when the library was
    built; of a template, the most any of its instances uses."""
    regs, name = {}, None
    with open(library_path(source) + ".ptxas") as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                for k in kernels:  # a mangled name holds <length><name>
                    if f"{len(k)}{k}" in name:
                        regs[k] = max(regs.get(k, 0), int(m.group(1)))
                name = None
    return regs


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
