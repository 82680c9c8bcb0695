"""Device transforms: sort-based transpose, map and symmetrize on a torch
device.

Counterpart of ``webgraph_tpu/transform/device.py``.  The reference's
offline transforms are external-memory sort pipelines (scan arcs -> sorted
batches -> k-way merge, Transform.java:964-1052 transpose, :1284-1320
processBatch, :1505-1539 mapOffline); on the card the arc array fits, so
each transform is one ``torch.sort`` over a packed int64 key
``(src << 32) | dst`` (node ids are below 2**31, so the key orders arcs by
source, then target), then sorted-run flags and a prefix-sum compaction
for the dedup, and ``torch.searchsorted`` for the CSR offsets.  Nothing is
read back to the host inside a pipeline.

The tensor-level forms return ``(offsets int64[n+1], succ int32[k], m)``
on the device: ``succ`` holds the input's arc count ``k`` of slots, its
first ``m`` the real arcs, the tail :data:`SENT`.  ``m`` is a 0-d int64
tensor where a dedup or a deletion decides it, and an int for the
transpose.  The host wrappers return exact NumPy CSR equal to the host
copy of ``transform/transform.py``.
"""

from __future__ import annotations

import numpy as np
import torch

SENT = 2**31 - 1                 # the node id of a deleted arc's ends
SENT_KEY = (SENT << 32) | SENT   # its key, the largest: it sorts last
_LOW = 2**32 - 1


def arcs_of(offsets: torch.Tensor, succ: torch.Tensor):
    """``(src int32[m], dst int32[m])`` of a CSR on its device."""
    n = offsets.numel() - 1
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=offsets.device),
        offsets[1:] - offsets[:-1], output_size=succ.numel())
    return src, succ.to(torch.int32)


def _pack(src, dst):
    return (src.to(torch.int64) << 32) | dst.to(torch.int64)


def _unpack(key):
    return (key >> 32).to(torch.int32), (key & _LOW).to(torch.int32)


def sorted_arcs_to_csr(src_s, dst_s, n: int, m=None):
    """CSR from (src, dst)-sorted arcs on their device: the offsets by
    binary search over the sorted sources (:data:`SENT` tails sort past
    every node, so the search stops before them).  ``m`` caps the offsets
    at the real arcs where the tail holds compacted-away slots."""
    offsets = torch.searchsorted(
        src_s, torch.arange(n + 1, dtype=src_s.dtype, device=src_s.device),
        side="left")
    if m is not None:
        offsets = torch.minimum(offsets, torch.as_tensor(m, device=offsets.device))
    return offsets, dst_s


def sort_dedup_arcs(src, dst):
    """Sort arcs by (src, dst) and compact away duplicates and deleted arcs
    (those with ``src == SENT``) on their device: one sort of the packed
    keys, a flag at the first arc of each run of equal keys, and a scatter
    to the prefix sum of the flags (the sorted-batch dedup of
    Transform.java:1291-1318).  Returns ``(src_c, dst_c, m)``: int32 arrays
    of the input's length whose first ``m`` slots are the unique kept arcs,
    the tail :data:`SENT`; ``m`` a 0-d int64 tensor, 0 for no arcs."""
    k = src.numel()
    key = torch.sort(_pack(src, dst)).values
    take = key != SENT_KEY
    take[1:] &= key[1:] != key[:-1]
    pos = torch.cumsum(take, 0) - 1
    idx = torch.where(take, pos, k)
    out = torch.full((k + 1,), SENT_KEY, dtype=torch.int64, device=key.device)
    out.scatter_(0, idx, key)
    s1, s2 = _unpack(out[:k])
    return s1, s2, take.sum()


def transpose_arcs_device(src, dst, n: int):
    """Transpose: swap the ends, one sort, CSR (a well-formed graph has no
    duplicate arcs, so no dedup; Transform.java:964-1052).  Returns
    ``(offsets, succ, m)`` with ``m`` the arc count."""
    s1, s2 = _unpack(torch.sort(_pack(dst, src)).values)
    offsets, succ = sorted_arcs_to_csr(s1, s2, n)
    return offsets, succ, src.numel()


def map_arcs_device(src, dst, perm, n_out: int):
    """Map ``x -> perm[x]``: gather the permutation, mark deleted arcs
    (``perm[x] < 0`` at either end) with :data:`SENT`, sort, dedup, CSR
    (Transform.map, Transform.java:654-723 / mapOffline :1510-1539)."""
    perm = perm.to(torch.int64)
    ms, md = perm[src.long()], perm[dst.long()]
    drop = (ms < 0) | (md < 0)
    ms = torch.where(drop, SENT, ms)
    md = torch.where(drop, SENT, md)
    s1, s2, m = sort_dedup_arcs(ms, md)
    offsets, succ = sorted_arcs_to_csr(s1, s2, n_out, m)
    return offsets, succ, m


def symmetrize_arcs_device(src, dst, n: int):
    """Symmetrize: one sort over the arcs and their reverses, dedup, CSR
    (Transform.symmetrize, :913-951)."""
    s1, s2, m = sort_dedup_arcs(torch.cat([src, dst]), torch.cat([dst, src]))
    offsets, succ = sorted_arcs_to_csr(s1, s2, n, m)
    return offsets, succ, m


# ----------------------------------------------------------------------
# graphs on the device, and the host wrappers
# ----------------------------------------------------------------------


def graph_csr(g, device="cuda"):
    """``(offsets int64[n+1], succ int32[m])`` of ``g`` on ``device``.  A
    ``BVGraph`` that a kernel decodes is decoded there
    (``formats/bvgraph.py::decode_to_csr``: K1 or K2 on the card, their
    plain versions on the CPU), so its CSR never passes through the host;
    any other graph goes through ``g.to_csr()`` and one copy."""
    from webgraph_tpu_torch.formats import bvgraph as F

    if isinstance(g, F.BVGraph) and F.K2.supports(g):
        off, succ = F.decode_to_csr(g, device)
        return off, succ
    off, succ = g.to_csr()
    return (torch.as_tensor(np.asarray(off, dtype=np.int64), device=device),
            torch.as_tensor(np.asarray(succ, dtype=np.int32), device=device))


def _host(offsets, succ, m=None):
    m = succ.numel() if m is None else int(m)
    return offsets.cpu().numpy().astype(np.int64), succ[:m].cpu().numpy()


def transpose_device(g, device="cuda"):
    """Transpose on ``device``.  Returns ``(offsets, succ)`` as NumPy
    arrays, equal to ``transform.transpose``."""
    off, succ = graph_csr(g, device)
    return _host(*transpose_arcs_device(*arcs_of(off, succ), g.num_nodes()))


def map_device(g, perm, device="cuda"):
    """Renumber ``x -> perm[x]`` on ``device`` (``perm[x] < 0`` deletes the
    node and its arcs).  Returns ``(offsets, succ)`` as NumPy arrays, equal
    to ``transform.map_graph``."""
    perm = np.asarray(perm, dtype=np.int64)
    n_out = int(perm.max(initial=-1)) + 1
    off, succ = graph_csr(g, device)
    return _host(*map_arcs_device(*arcs_of(off, succ),
                                  torch.as_tensor(perm, device=device), n_out))


def symmetrize_device(g, device="cuda"):
    """Union with the transpose on ``device``.  Returns ``(offsets, succ)``
    as NumPy arrays, equal to ``transform.symmetrize``."""
    off, succ = graph_csr(g, device)
    return _host(*symmetrize_arcs_device(*arcs_of(off, succ),
                                         g.num_nodes()))
