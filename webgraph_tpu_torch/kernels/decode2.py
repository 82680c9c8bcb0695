"""K1, the bounded-chain BVGraph decoder: its plan, the plain PyTorch version
of its code-start doubling and the wrapper of its kernels.

Counterpart of ``webgraph_tpu/pallas/decode2.py``, the route of
``decode_to_csr_auto`` for graphs whose reference chains reach back at most
:data:`MAX_REACH` nodes.  The TPU kernel decodes per-lane node ranges into
a slab; here the records are decoded in parallel straight into CSR, with
K2's depth plan (``kernels/levels.py``):

1. ``k1_parse``, one launch: every record a thread, except the long ones
   (outdegree >= ``long_arcs``, listed at plan time), a block each.  A
   long record's residuals are decoded in tiles of :data:`TILE_BITS` bits,
   their code starts found by doubling (:func:`code_starts_plain` is that
   step in plain torch), their values by a prefix sum, and merged with the
   interval runs by rank.  The result is what :func:`parse_records_plain`
   computes.
2. ``k2_resolve``, K2's copy kernel, one persistent launch: a warp a node
   of depth >= 1, its parent complete before it (:func:`resolve_copies_plain`).

:func:`decode_records` launches both for CUDA tensors and takes the plain
versions for CPU tensors.  Batched random access (``kernels/query2.py``)
calls it with the depth plan of a batch's ancestor closure in place of the
whole graph's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels.levels import (  # noqa: F401  (K1's names)
    ERR_CODE, ERR_COUNT, ERR_PARENT, ERR_PLAN, ERR_REF, MAX_WINDOW, Parsed,
    TILE_BITS, Planned, check_errors, check_inputs, code_starts_plain,
    coding_key, host_sizes, parse_records_plain, plan_levels, planned_fields,
    resolve_copies_plain, stream_words)
from webgraph_tpu_torch.kernels.levels import decode_plain as \
    decode_records_plain
from webgraph_tpu_torch.kernels.plan import chain_roots, scan_structure
from webgraph_tpu_torch.timing import span

MAX_REACH = 256  # longest reference reach (nodes) K1 takes
# records of at least this many arcs are parsed by a block each
LONG_ARCS = 1024
RANK_NONE = 2**31 - 1  # the rank of a node the plan does not list


def _minanc(scan, n):
    """Smallest ancestor id of each node (itself if it has no reference):
    the root of its reference chain, since a parent lies before its
    node."""
    return chain_roots(scan.ref[:n].astype(np.int64))[0]


def supports(g, scan=None) -> bool:
    """Whether K1 can decode ``g``: every coding has a window reader
    (GAMMA/DELTA/ZETA/UNARY), window <= 7, and the reference-chain reach is
    at most :data:`MAX_REACH` nodes.  ``scan``: the graph's structure scan,
    where the caller has it."""
    s = g.settings
    ok_codings = all(c in (C.GAMMA, C.DELTA, C.ZETA, C.UNARY) for c in (
        s.outdegree_coding, s.reference_coding, s.block_count_coding,
        s.block_coding, s.residual_coding))
    if not (ok_codings and s.window_size <= MAX_WINDOW):
        return False
    if s.max_ref_count >= 0 and \
            s.window_size * max(s.max_ref_count, 1) <= MAX_REACH:
        return True
    if scan is None:
        scan = scan_structure(g)
    n = g.num_nodes()
    return int((np.arange(n) - _minanc(scan, n)).max(initial=0)) <= MAX_REACH


# ----------------------------------------------------------------------
# planning
# ----------------------------------------------------------------------


@dataclass
class Prepared(Planned):
    """A graph planned for K1 on one device."""

    long: torch.Tensor     # int32 positions in order of the long records
    long_arcs: int         # the outdegree from which a record is long

    def args(self) -> tuple:
        return super().args() + (self.long,)


def prepare(g, device="cuda", *, scan=None,
            long_arcs: int = LONG_ARCS) -> Prepared:
    """Scan (unless ``scan`` is given), plan and move to ``device``
    everything a K1 decode needs: the depth plan, and the records of at
    least ``long_arcs`` arcs, which ``k1_parse`` gives a block each."""
    if not supports(g, scan):
        raise NotImplementedError(
            f"K1 does not decode this graph (codings "
            f"{g.settings.flags_string()!r}, window {g.settings.window_size}, "
            f"reach past {MAX_REACH})")
    if long_arcs < 1:
        raise ValueError("long_arcs must be at least 1")
    with span("prepare.plan"):
        plan = plan_levels(g, scan if scan is not None
                           else scan_structure(g), long_arcs)
    with span("prepare.upload"):
        fields = planned_fields(g, device, plan)
        long = plan.long.to(fields["device"])
    return Prepared(**fields, long=long, long_arcs=long_arcs)


def decode_prepared(prep: Prepared):
    """``(offsets int64[n+1], successors int32[m])`` on the prepared
    device."""
    return prep.offsets, decode_records(*prep.args(), **prep.sizes())


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------


def _check_long(fn, long, order):
    if long.device != order.device or long.dtype != torch.int32 \
            or long.dim() != 1 or not long.is_contiguous():
        raise ValueError(f"{fn}: long must be a contiguous 1-d int32 tensor "
                         f"on {order.device}")


def _parse(words, bo, order, bounds, offsets, skey, bstart, long, ext, bend,
           succ):
    """One call of ``wgt_k1_parse`` over the records ``order`` lists;
    returns the error array (by position in ``order``), the per-node
    scratch (rank, reference, extras count, ready flag; int32 (4, n),
    indexed by node id over all n nodes of the graph, as the kernels write
    it) and the launches of ``k1_parse`` as the C entry point reports
    them.  When ``order`` lists a subset, every rank starts past every
    position, so that ``k2_resolve`` fails a node whose parent ``order``
    leaves out (ERR_PLAN) at once rather than wait for a flag no kernel
    sets; over every node ``k1_parse`` writes every rank itself."""
    dev = words.device
    k = order.numel()
    node = torch.empty((4, bo.numel() - 1), dtype=torch.int32, device=dev)
    if k < node.shape[1]:
        node[0].fill_(RANK_NONE)
    err = torch.empty(k, dtype=torch.int32, device=dev)
    b1 = int(bounds[1]) if len(bounds) > 1 else k
    launched = (ctypes.c_int * 1)()
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_k1_parse(
            words.data_ptr(), (words.numel() - 2) * 64, bo.data_ptr(),
            offsets.data_ptr(), order.data_ptr(), bstart.data_ptr(), k, b1,
            long.data_ptr(), long.numel(), *skey, ext.data_ptr(),
            bend.data_ptr(), *(node[r].data_ptr() for r in range(4)),
            succ.data_ptr(), err.data_ptr(), ctypes.addressof(launched),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_k1_parse", rc)
    return err, node, launched[0]


def decode_records(words, bo, order, bounds, offsets, skey, bstart, long, *,
                   m=None, nblocks=None):
    """Decode the nodes ``order`` lists into CSR: returns the int32
    successors ``succ[offsets[x]:offsets[x+1]]`` of every listed node ``x``
    (``succ`` holds the graph's m slots; those of nodes not listed are left
    unwritten).  Raises if a node reports an error.

    The arguments are those of ``decode.decode_levels`` (the depth plan of
    ``levels.plan_levels``, the stream, the sizes ``m`` and ``nblocks`` on
    the host), and ``long``: int32 positions in ``order`` of the records
    that ``k1_parse`` gives a block each, ascending (``Prepared.long``).
    Every record not listed gets a thread, so the list changes only who
    parses a record, never the result.  ``order`` may list a subset of
    the graph's nodes that holds every parent of its nodes, in depth order
    (``levels.level_order`` over an ancestor closure: the queries of
    ``kernels/query2.py``); ``bo``, ``offsets`` and ``bstart`` still cover
    the whole graph.

    CPU tensors take the steps of :func:`decode_records_plain`
    (:func:`parse_records_plain`, :func:`resolve_copies_plain`); CUDA
    tensors launch ``k1_parse`` and then, when a node has depth >= 1,
    ``k2_resolve`` (``decode.launch_resolve``), and are checked once
    after the launches.
    Nothing is read back from the card before the launches when the sizes
    are given.  ``decode_records.counts`` adds up each kernel's launches,
    under ``reads`` the reads from the card (one a CUDA call that decodes
    a record: the error check) and under ``levels`` the depth levels of
    the plans the CUDA calls resolved (``bounds.size - 1`` a call).

    Host spans (``timing.span``): ``decode``, holding ``decode.check``,
    ``decode.alloc`` (CUDA), ``decode.k1_parse``, ``decode.k2_resolve``
    (counting ``levels``, the plan's depth levels) and ``decode.wait``
    (the error check)."""
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_records: unsupported device {dev}")
    with span("decode"):
        with span("decode.check"):
            bounds = np.ascontiguousarray(bounds, dtype=np.int64)
            levels = bounds.size - 1
            m, nblocks = host_sizes(offsets, bstart, m, nblocks)
            if dev.type == "cuda":
                check_inputs("decode_records", words, bo, order, bounds,
                             offsets, skey, bstart, m=m, nblocks=nblocks)
                _check_long("decode_records", long, order)
        if dev.type == "cpu":
            with span("decode.k1_parse"):
                parsed = parse_records_plain(words, bo, order, bounds,
                                             offsets, skey, bstart, m=m,
                                             nblocks=nblocks)
            with span("decode.k2_resolve") as s:
                s.count(levels=levels)
                succ, err = resolve_copies_plain(parsed, order, bounds,
                                                 offsets, bstart, m=m)
            with span("decode.wait"):
                check_errors(err, order)
            return succ
        with span("decode.alloc"):
            succ = torch.empty(m, dtype=torch.int32, device=dev)
            if order.numel() == 0:
                return succ
            ext = torch.empty_like(succ)
            bend = torch.empty(nblocks, dtype=torch.int32, device=dev)
        with span("decode.k1_parse"):
            err, node, parses = _parse(words, bo, order, bounds, offsets,
                                       skey, bstart, long, ext, bend, succ)
        decode_records.counts["k1_parse"] += parses
        with span("decode.k2_resolve") as s:
            s.count(levels=levels)
            decode_records.counts["k2_resolve"] += K2.launch_resolve(
                offsets, order, bounds, bstart, bend, ext, node, succ, err)
        decode_records.counts["levels"] += levels
        decode_records.counts["reads"] += 1
        with span("decode.wait"):
            check_errors(err, order)
        return succ


decode_records.counts = {"k1_parse": 0, "k2_resolve": 0, "reads": 0,
                         "levels": 0}


def parse_records(words, bo, order, bounds, offsets, skey, bstart, long, *,
                  m=None, nblocks=None) -> Parsed:
    """``k1_parse`` alone, laid out as :func:`parse_records_plain` gives
    it: every listed node's extras in ``ext`` (0 elsewhere), depth 0 too.
    It does not raise on node errors (they are in ``err``).  Where
    ``order`` lists a subset, ``ref`` holds the listed nodes' references
    and is unwritten elsewhere.  CPU tensors take
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
    _check_long("parse_records", long, order)
    ext = torch.zeros(m, dtype=torch.int32, device=dev)
    bend = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    if order.numel() == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Parsed(ext, bend, torch.zeros(bo.numel() - 1,
                                             dtype=torch.int32, device=dev),
                      empty)
    err, node, parses = _parse(words, bo, order, bounds, offsets, skey,
                               bstart, long, ext, bend, ext)
    parse_records.launches += parses
    return Parsed(ext, bend, node[1], err)


parse_records.launches = 0
