"""K2, the long-reference-chain BVGraph decoder: its planning and the
wrapper of its two kernels.

Counterpart of ``webgraph_tpu/pallas/decode.py``, the route of
``decode_to_csr_auto`` for graphs whose reference chains reach back
further than K1 covers (maxref unbounded, ``decode2.supports`` False).
The TPU kernel parses each 1,024-node block's records (``_p1b_blocks``,
``_p2_extras``), resolves the copies one in-block chain depth at a time
(``_p3_round``) and carries a halo of the last ``window`` lists to the next
block.  Here the same split covers the whole graph, with the depth plan
and the plain versions that K1 shares (``kernels/levels.py``):
``k2_parse`` parses every record in one launch
(:func:`parse_records_plain`), and ``k2_resolve`` resolves the copy chains
in one persistent launch, a warp a node, in depth order
(:func:`resolve_copies_plain`).  K1's route resolves its copies with the
same ``k2_resolve`` (:func:`launch_resolve`).

:func:`decode_levels` launches both kernels of ``csrc/decode.cu`` for CUDA
tensors (one C call, two launches) and takes :func:`decode_levels_plain`,
the composition of the two plain versions, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels.levels import (  # noqa: F401  (K2's names)
    ERR_CODE, ERR_COUNT, ERR_PARENT, ERR_PLAN, ERR_REF, ERR_WAIT, MAX_WINDOW,
    LevelPlan, Parsed, Planned, _segments, check_errors, check_inputs,
    host_sizes, merge_copies_plain, parse_records_plain, plan_levels,
    planned_fields, resolve_copies_plain)
from webgraph_tpu_torch.kernels.levels import decode_plain as \
    decode_levels_plain
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.timing import span


def supports(g) -> bool:
    """Whether K2 can decode ``g``: window <= 7, and every coding of the
    outdegrees, references, block counts, blocks and residuals has a window
    reader (GAMMA/DELTA/ZETA/UNARY).  The predicate of the JAX package's
    ``decode_to_csr_auto`` for its block-phase kernel."""
    s = g.settings
    return s.window_size <= MAX_WINDOW and all(
        c in (C.GAMMA, C.DELTA, C.ZETA, C.UNARY) for c in (
            s.outdegree_coding, s.reference_coding, s.block_count_coding,
            s.block_coding, s.residual_coding))


class LevelPrepared(Planned):
    """A graph planned for K2 on one device."""


def prepare(g, device="cuda", *, scan=None) -> LevelPrepared:
    """Scan (unless ``scan`` is given), plan and move to ``device``
    everything a K2 decode needs."""
    if not supports(g):
        raise NotImplementedError(
            f"K2 does not decode this graph (codings "
            f"{g.settings.flags_string()!r}, window {g.settings.window_size})")
    with span("prepare.plan"):
        plan = plan_levels(g, scan if scan is not None
                           else scan_structure(g))
    with span("prepare.upload"):
        return LevelPrepared(**planned_fields(g, device, plan))


def decode_prepared(prep: LevelPrepared):
    """``(offsets int64[n+1], successors int32[m])`` on the prepared
    device."""
    return prep.offsets, decode_levels(*prep.args(), **prep.sizes())


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------


def _launch(words, bo, order, bounds, offsets, skey, bstart, ext, bend, succ,
            resolve):
    """One call of ``wgt_k2_decode``; returns the error array, the
    per-node scratch (rank, reference, extras count, ready flag) and the
    launches of ``k2_parse`` and ``k2_resolve`` as the C entry point
    reports them."""
    dev = words.device
    n = order.numel()
    if n != bo.numel() - 1:
        # the C entry point sizes its scratch and resets the ready flags by
        # the order's length: a subset goes through K1's wrappers
        raise ValueError("K2's kernels decode every node of the graph: "
                         "order must list all of them")
    node = torch.empty((4, n), dtype=torch.int32, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = int(bounds[1]) if len(bounds) > 1 else n
    launched = (ctypes.c_int * 2)()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wgt_k2_decode(
            words.data_ptr(), (words.numel() - 2) * 64, bo.data_ptr(),
            offsets.data_ptr(), order.data_ptr(), bstart.data_ptr(), n, b1,
            *skey, ext.data_ptr(), bend.data_ptr(),
            *(node[r].data_ptr() for r in range(4)), ticket.data_ptr(),
            succ.data_ptr(), err.data_ptr(), int(resolve),
            ctypes.addressof(launched), stream)
    _build.check_launch("wgt_k2_decode", rc)
    return err, node, tuple(launched)


def launch_resolve(offsets, order, bounds, bstart, bend, ext, node, succ,
                   err) -> int:
    """``k2_resolve`` alone, after another parse (K1's ``k1_parse``) has
    filled ``ext``, ``bend``, ``node`` (rank, reference, extras count and
    ready flag of every node, int32 (4, n)) and ``err``: the copies of every
    node of depth >= 1 into ``succ``, errors into ``err``.  CUDA tensors
    only, not checked here and not waited for; returns the launches (0 when
    no node has a parent)."""
    dev = offsets.device
    n = order.numel()
    b1 = int(bounds[1]) if len(bounds) > 1 else n
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 1)()
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_k2_resolve(
            offsets.data_ptr(), order.data_ptr(), b1, n, bstart.data_ptr(),
            bend.data_ptr(), ext.data_ptr(),
            *(node[r].data_ptr() for r in range(4)), ticket.data_ptr(),
            succ.data_ptr(), err.data_ptr(), ctypes.addressof(launched),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_k2_resolve", rc)
    return launched[0]


def decode_levels(words, bo, order, bounds, offsets, skey, bstart, *,
                  m=None, nblocks=None):
    """Decode every node into CSR: returns the int32 successors
    ``succ[offsets[x]:offsets[x+1]]`` of every node ``x``.  Raises if a node
    reports an error.

    ``words``: int64 stream words from ``levels.stream_words``; ``bo``:
    int64 bit offsets of the graph's nodes (n + 1); ``order``: int32 node
    ids by depth; ``bounds``: host int64 level bounds into ``order``;
    ``offsets``: int64 CSR offsets (n + 1); ``skey``: ``levels.coding_key``;
    ``bstart``: int64 prefix sum of the block counts (n + 1); ``m`` and
    ``nblocks``: ``offsets[-1]`` and ``bstart[-1]`` as host ints (all from
    :func:`plan_levels`; where the sizes are not given they are read from
    the tensors, which waits for the card).

    CPU tensors take :func:`decode_levels_plain`; CUDA tensors launch
    ``k2_parse`` and, when a node has depth >= 1, ``k2_resolve`` (one C
    call), and are checked once after the launches.
    ``decode_levels.counts`` adds up each kernel's launches."""
    dev = words.device
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    m, nblocks = host_sizes(offsets, bstart, m, nblocks)
    if dev.type == "cpu":
        succ, err = decode_levels_plain(words, bo, order, bounds, offsets,
                                        skey, bstart, m=m, nblocks=nblocks)
        check_errors(err, order)
        return succ
    if dev.type != "cuda":
        raise ValueError(f"decode_levels: unsupported device {dev}")
    check_inputs("decode_levels", words, bo, order, bounds, offsets, skey,
                 bstart, m=m, nblocks=nblocks)
    n = order.numel()
    succ = torch.empty(m, dtype=torch.int32, device=dev)
    if n == 0:
        return succ
    ext = torch.empty_like(succ)
    bend = torch.empty(nblocks, dtype=torch.int32, device=dev)
    err, _, (parses, resolves) = _launch(words, bo, order, bounds, offsets,
                                         skey, bstart, ext, bend, succ, True)
    decode_levels.counts["k2_parse"] += parses
    decode_levels.counts["k2_resolve"] += resolves
    check_errors(err, order)
    return succ


decode_levels.counts = {"k2_parse": 0, "k2_resolve": 0}


def parse_records(words, bo, order, bounds, offsets, skey, bstart, *,
                  m=None, nblocks=None) -> Parsed:
    """``k2_parse`` alone, laid out as :func:`parse_records_plain` gives
    it: every node's extras in ``ext`` (0 elsewhere), depth 0 too.  It does
    not raise on node errors (they are in ``err``).  CPU tensors take
    :func:`parse_records_plain`."""
    dev = words.device
    m, nblocks = host_sizes(offsets, bstart, m, nblocks)
    if dev.type == "cpu":
        return parse_records_plain(words, bo, order, bounds, offsets, skey,
                                   bstart, m=m, nblocks=nblocks)
    if dev.type != "cuda":
        raise ValueError(f"parse_records: unsupported device {dev}")
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    check_inputs("parse_records", words, bo, order, bounds, offsets, skey,
                 bstart, m=m, nblocks=nblocks)
    n = order.numel()
    ext = torch.zeros(m, dtype=torch.int32, device=dev)
    bend = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Parsed(ext, bend, empty, empty)
    err, node, (parses, _) = _launch(words, bo, order, bounds, offsets, skey,
                                     bstart, ext, bend, ext, False)
    parse_records.launches += parses
    return Parsed(ext, bend, node[1], err)


parse_records.launches = 0


# ----------------------------------------------------------------------
# the warp-compaction probe
# ----------------------------------------------------------------------


def compact_probe_plain(vals, cnt, qpos, pool_size: int, depth: int = 16):
    """Plain version of :func:`compact_probe`: lane l's ``cnt[l]`` values
    ``vals[:cnt[l], l]`` go to ``pool[pre[l] ..)``, ``pre`` the exclusive
    prefix sum of ``cnt``; then ``q[k, l] = pool[qpos[l] + k]`` for
    ``k < depth``.  Returns ``(pool, q)``, int32."""
    dev = vals.device
    cnt = cnt.long()
    seg, k = _segments(cnt)
    pre = torch.cumsum(cnt, 0) - cnt
    pool = torch.zeros(pool_size, dtype=torch.int32, device=dev)
    pool[pre[seg] + k] = vals[k, seg]
    q = pool[qpos.long()[None, :] + torch.arange(depth, device=dev)[:, None]]
    return pool, q


def compact_probe(vals, cnt, qpos, pool_size: int, depth: int = 16):
    """The warp-compaction helper of ``k2_resolve`` (``warp_excl_scan``) on
    its own, in ``k2_compact_probe``: the counterpart of the JAX package's
    ``scripts/pallas_compact_chip.py`` probe of ``compact_slab`` and
    ``pool_fetch_queue``.  ``vals`` int32 (rows, lanes), ``cnt`` and
    ``qpos`` int32 (lanes,), lanes a multiple of 32 up to 1,024, counts
    0..31 and at most ``rows``.  CPU tensors take
    :func:`compact_probe_plain`."""
    if vals.device.type == "cpu":
        return compact_probe_plain(vals, cnt, qpos, pool_size, depth)
    rows, lanes = vals.shape
    dev = vals.device
    if lanes % 32 or not 0 < lanes <= 1024 or vals.dtype != torch.int32 \
            or not vals.is_contiguous():
        raise ValueError("compact_probe: vals must be contiguous int32 "
                         "(rows, lanes), lanes a multiple of 32 up to 1024")
    for name, t in (("cnt", cnt), ("qpos", qpos)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (lanes,):
            raise ValueError(f"compact_probe: {name} must be int32 "
                             f"({lanes},) on {dev}")
    c = cnt.long()
    if bool((c < 0).any() | (c > min(31, rows)).any()) \
            or int(c.sum()) > pool_size \
            or bool((qpos < 0).any() | (qpos.long() + depth > pool_size).any()):
        raise ValueError("compact_probe: counts or fetch positions out of "
                         "range")
    cnt, qpos = cnt.contiguous(), qpos.contiguous()
    pool = torch.zeros(pool_size, dtype=torch.int32, device=dev)
    q = torch.empty((depth, lanes), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_k2_compact_probe(
            vals.data_ptr(), cnt.data_ptr(), qpos.data_ptr(), lanes, depth,
            pool.data_ptr(), q.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_k2_compact_probe", rc)
    compact_probe.launches += 1
    return pool, q


compact_probe.launches = 0
