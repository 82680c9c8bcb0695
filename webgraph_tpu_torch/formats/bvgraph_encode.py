"""BVGraph encoder on a torch device: a CSR in, ``.graph`` and ``.offsets``
bytes out, identical to the host store (``formats/bvgraph.py::BVGraph.store``).

Counterpart of the JAX package's ``webgraph_tpu/formats/bvgraph_jax_encode.py``
(the reference storeInternal and diffComp, BVGraph.java:2436-2650,
:2049-2219), under its public names.  An encode is three kernel launches
(``kernels/encode.py``, ``csrc/encode.cu``) and two host reads:

1. :func:`compute_costs` (``enc_costs``): every (node, shift) diffComp cost;
2. :func:`select_references` (``enc_select``): the greedy reference choice
   under ``maxRefCount``, the first candidate winning a tie;
3. each node's record length, ``node_bits`` = its outdegree code plus,
   where it has arcs, ``costs[x, refs[x]]`` (:func:`node_bits_of`), and
   the bit starts and ``.offsets`` positions by ``torch.cumsum``; the host
   reads the two totals once, to size the streams;
4. ``enc_emit``: every record and ``.offsets`` code written in one launch,
   with the stats and both gap histograms; the streams' words are put in
   file byte order on the device, and the host copies the streams and
   stats back once (into page-locked memory on CUDA).

Inputs may be NumPy arrays or torch tensors; a CUDA tensor is used in
place, so a CSR decoded on the card (``decode_to_csr(..., device="cuda")``,
``DeviceCSR``) encodes with no host round trip.  CUDA tensors take the
kernels, CPU tensors their plain PyTorch versions; another device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.kernels import encode as K
from webgraph_tpu_torch.kernels.encode import (make_len_fn,  # noqa: F401
                                               make_pat_fn)
from webgraph_tpu_torch.timing import span


def skey_of(s):
    """The settings tuple the functions below take: (outdegree, reference,
    block count, block, residual codings, zeta_k, window, min interval
    length, max ref count)."""
    return (
        s.outdegree_coding,
        s.reference_coding,
        s.block_count_coding,
        s.block_coding,
        s.residual_coding,
        s.zeta_k,
        s.window_size,
        s.min_interval_length,
        s.max_ref_count,
    )


def _tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                      dtype=dtype)


def compute_costs(off, succ, src, skey, shard_start: int = 0):
    """All (node, shift) diffComp costs of the CSR ``(off int64[n+1], succ
    int32[m])``: ``(costs int32[n, w+1], valid bool[n, w+1])``, slot 0 the
    cost without a reference; shifts that reach before ``shard_start`` are
    no candidates.  ``src`` (each arc's source) serves the plain version
    only; None makes it there."""
    return K.enc_costs(off, succ, skey, shard_start, src=src)


def select_references(costs, valid, skey):
    """Greedy reference selection under the maxRefCount chain constraint:
    ``(refs int32[n], depths int32[n])``."""
    return K.enc_select(costs, valid, skey[8])


def node_bits_of(off, costs, refs, skey):
    """Each node's record length in bits: its outdegree code and, where it
    has arcs, the cost of its chosen shift (``costs[x, refs[x]]``: the
    reference, the blocks and the extras).  It equals the JAX module's
    ``_chosen_structure(...)["node_bits"]`` (tests/test_torch_encode_ref.py
    holds the starts to its ``emit_graph``'s)."""
    d = off[1:] - off[:-1]
    chosen = costs.gather(1, refs.long().unsqueeze(1)).squeeze(1).long()
    return make_len_fn(skey[0], skey[5])(d) + torch.where(d > 0, chosen, 0)


def plan_sizes(off, succ, src, refs, skey, shard_start: int = 0):
    """``(total bits, blocks, intervals, residuals)`` of the records for
    ``refs``, as the JAX ``plan_sizes``, from the plain arc-parallel
    structure (``kernels/encode.py::chosen_structure``) on the tensors'
    device; the encode itself needs only the bits, which it takes from the
    costs."""
    st = K.chosen_structure(off, succ, refs, skey, src=src)
    det = st.det
    return (int(st.node_bits.sum()), int(st.block_count.sum()),
            int(torch.where(st.gate, det.int_count, 0).sum()),
            int(torch.where(st.gate, det.res_count, 0).sum()))


def _starts(node_bits):
    return torch.cat([node_bits.new_zeros(1), torch.cumsum(node_bits, 0)])


def _raise_on(flag, what):
    if flag:
        raise RuntimeError(f"{what}: a record or code is not where the plan "
                           f"put it (error flags {int(flag)})")


def emit_graph(off, succ, src, refs, depths, skey, shard_start: int = 0,
               total_bits=None, total_blocks=None, total_ints=None,
               total_res=None, *, costs=None):
    """The ``.graph`` stream for ``refs``: ``(words int32[W], starts
    int64[n+1], stats int64[10], successor gap histogram int64[33],
    residual gap histogram int64[33])``, W = ceil(total_bits / 32) + 2 as
    the JAX ``emit_graph``.  The starts come from ``costs``
    (:func:`compute_costs` runs when they are not given).  The block,
    interval and residual totals are the JAX signature's and not needed."""
    if costs is None:
        costs, _ = compute_costs(off, succ, src, skey, shard_start)
    starts = _starts(node_bits_of(off, costs, refs, skey))
    if total_bits is None:
        total_bits = int(starts[-1])
    words = torch.zeros((total_bits + 31) // 32 + 2, dtype=torch.int32,
                        device=off.device)
    stats = torch.zeros(K.STATS + 1, dtype=torch.int64, device=off.device)
    K.enc_emit(off, succ, refs, depths, starts, skey, stats, words=words)
    _raise_on(int(stats[K.ERR]), "emit_graph")
    return (words, starts, stats[:K.NSTATS],
            stats[K.NSTATS:K.NSTATS + K.NBINS],
            stats[K.NSTATS + K.NBINS:K.STATS])


def emit_offsets(node_bits, offset_coding: int, zeta_k: int, total_obits=None):
    """The ``.offsets`` stream: the code of each node's bit length after a
    leading 0 (the reference writeOffset path), as int32 words,
    ceil(total_obits / 32) + 2 of them."""
    node_bits = node_bits.long()
    opos = K.offset_positions(node_bits, offset_coding, zeta_k)
    if total_obits is None:
        total_obits = int(opos[-1])
    owords = torch.zeros((total_obits + 31) // 32 + 2, dtype=torch.int32,
                         device=node_bits.device)
    stats = torch.zeros(K.STATS + 1, dtype=torch.int64,
                        device=node_bits.device)
    skey = (offset_coding,) * 5 + (zeta_k, 0, 0, 0)
    K.enc_emit(None, None, None, None, _starts(node_bits), skey, stats,
               opos=opos, owords=owords, offset_coding=offset_coding)
    _raise_on(int(stats[K.ERR]), "emit_offsets")
    return owords


def encode_device(offsets, succ, settings, shard_start: int = 0,
                  device="cuda"):
    """Encode a CSR graph to BVGraph bytes on ``device``.

    Returns ``(graph_bytes, graph_bits, offsets_bytes, offsets_bits,
    stats)``, ``stats`` the host ``_CompressionStats`` fields.  Three
    launches on a CUDA device (``enc_costs``, ``enc_select``, ``enc_emit``)
    and two host reads (:attr:`encode_device.reads`): the two totals (and
    ``enc_select``'s three counts), then the streams and stats.  Raises
    ValueError for a graph without nodes or arcs and RuntimeError if a
    record is not the length its cost planned.

    After ``enc_emit`` the bytes of each 32-bit word of the two streams
    are reversed on the device (the stats that follow them are not), so
    the streams leave it in file byte order.  On a CUDA device the second
    read copies them and the stats into page-locked host memory (a block
    that PyTorch's caching host allocator hands out again on the next
    call of that size); each stream then takes one copy into its
    ``bytes``, and nothing returned shares memory with that block.

    Host spans (``timing.span``): ``encode``, holding ``encode.costs``,
    ``encode.select``, ``encode.layout`` (the record lengths, bit starts
    and ``.offsets`` positions), ``encode.read_totals``, ``encode.emit``
    (the launch and the byte swap), ``encode.read_streams`` (both reads
    count ``d2h_bytes``; ``encode.read_totals`` also ``select_rounds``,
    ``select_rerun_nodes`` and ``select_serial_nodes``,
    ``enc_select.last_counts``: zeros on the CPU; ``encode.read_streams``
    also ``pinned_bytes``, the bytes of the read that landed in
    page-locked memory: all of them on CUDA, 0 on the CPU) and
    ``encode.unpack`` (the bytes and stats)."""
    with span("encode"):
        dev = torch.device(device)
        off = _tensor(offsets, torch.int64, dev)
        sc = _tensor(succ, torch.int32, dev)
        n, m = off.numel() - 1, sc.numel()
        if n < 1 or m == 0:
            raise ValueError("device encoder requires a non-empty graph")
        skey = skey_of(settings)
        off_c, zeta_k = settings.offset_coding, settings.zeta_k
        with span("encode.costs"):
            costs, valid = compute_costs(off, sc, None, skey, shard_start)
        with span("encode.select"):
            refs, depths = select_references(costs, valid, skey)
        with span("encode.layout"):
            node_bits = node_bits_of(off, costs, refs, skey)
            starts = _starts(node_bits)
            opos = K.offset_positions(node_bits, off_c, zeta_k)
            totals = torch.cat([torch.stack([starts[-1], opos[-1], off[-1]]),
                                K.enc_select.last_counts])
        with span("encode.read_totals") as s:
            s.count(d2h_bytes=totals.nbytes)
            tb, tob, m_off, rounds, rerun, walked = totals.tolist()
            s.count(select_rounds=rounds, select_rerun_nodes=rerun,
                    select_serial_nodes=walked)
        encode_device.reads += 1
        if m_off != m:
            raise ValueError(f"offsets end at {m_off}, but succ holds {m} "
                             f"arcs")
        with span("encode.emit"):
            wg, wo = (tb + 31) // 32 + 2, (tob + 31) // 32 + 2
            pad = (wg + wo) % 2  # the stats start on an 8-byte boundary
            buf = torch.zeros(wg + wo + pad + 2 * (K.STATS + 1),
                              dtype=torch.int32, device=dev)
            stats = buf[wg + wo + pad:].view(torch.int64)
            K.enc_emit(off, sc, refs, depths, starts, skey, stats,
                       words=buf[:wg], opos=opos, owords=buf[wg:wg + wo],
                       offset_coding=off_c)
            # MSB-first words to file byte order, the stats left as they are
            quads = buf[:wg + wo].view(torch.uint8).view(-1, 4)
            quads.copy_(quads.flip(1))
        with span("encode.read_streams") as s:
            host, pinned = buf.view(torch.uint8), 0
            if dev.type == "cuda":
                host = torch.empty(host.numel(), dtype=torch.uint8,
                                   pin_memory=True).copy_(host)
                pinned = host.nbytes
            s.count(d2h_bytes=buf.nbytes, pinned_bytes=pinned)
        encode_device.reads += 1
        with span("encode.unpack"):
            h = host.numpy()
            st = h[4 * (wg + wo + pad):].view(np.int64)
            _raise_on(int(st[K.ERR]), "encode_device")
            names = ("bits_outdegrees", "bits_references", "bits_blocks",
                     "bits_intervals", "bits_residuals", "copied_arcs",
                     "intervalised_arcs", "residual_arcs", "tot_ref",
                     "tot_dist")
            stats_out = {k: int(v) for k, v in zip(names, st[:K.NSTATS])}
            stats_out.update(
                tot_links=m, node_count=n,
                successor_gap_stats=st[K.NSTATS:K.NSTATS + K.NBINS].copy(),
                residual_gap_stats=st[K.NSTATS + K.NBINS:K.STATS].copy())
            return (h[:(tb + 7) // 8].tobytes(), tb,
                    h[4 * wg:4 * wg + (tob + 7) // 8].tobytes(), tob,
                    stats_out)


encode_device.reads = 0  # host reads: two an encode


def store_device(graph, basename, settings=None, device="cuda", **kwargs):
    """``BVGraph.store`` on ``device``: the graph's CSR there
    (``transform/device.py::graph_csr``: a ``BVGraph`` that a kernel
    decodes is decoded on the card), :func:`encode_device`, then the
    ``.graph``, ``.offsets`` and ``.properties`` files, identical to the
    host store's.  Returns the properties."""
    from webgraph_tpu_torch.formats.bvgraph import (
        GRAPH_EXTENSION, OFFSETS_EXTENSION, BVGraph, BVGraphSettings,
        _CompressionStats)
    from webgraph_tpu_torch.transform.device import graph_csr

    s = settings or BVGraphSettings(**kwargs)
    off, succ = graph_csr(graph, device)
    gb, gbits, ob, obits, st = encode_device(off, succ, s, device=device)
    with open(f"{basename}{GRAPH_EXTENSION}", "wb") as f:
        f.write(gb)
    with open(f"{basename}{OFFSETS_EXTENSION}", "wb") as f:
        f.write(ob)
    cs = _CompressionStats()
    for k, v in st.items():
        setattr(cs, k, v)
    cs.last_offset = gbits
    return BVGraph._write_properties(basename, off.numel() - 1, s, cs, gbits,
                                     obits, "BVGraph properties")
