"""``or_pull``: reachability by pull over an in-CSR, its plain PyTorch
versions and its wrappers.

A node's word holds one bit a source (source ``i`` of a batch at bit
``i``); a node may hold ``k`` words (``int64[n, k]``, row-major), one a
batch.  One level computes, from ``old`` into a new buffer::

    new[x] = old[x] | OR of old[y] over the in-arcs y -> x   (word by word)
    nb[x]  = new[x] & ~old[x]                 (the bits reached at this level)
    counts[j]     = sum of popcount(nb[x][j])
    bits[j][b]    = #{x : bit b of nb[x][j]}  (with ``perbit``)
    dist[x][j] = level + 1 where old[x][j] == 0 and new[x][j] != 0

It serves ``algo/device.py``: BFS, exact NF and geometric centralities.
It takes the place of the JAX package's segmented-OR scan
(``webgraph_tpu/algo/device.py::_seg_or_scan``) and the ``while_loop``s
around it, which exist because XLA has no scatter-OR; PyTorch has none
either, and no population count, so the port computes the levels in
``csrc/propagate.cu``.

:func:`propagate` runs levels until one reaches nothing (or a cap), all of
them in one launch of the kernel, which stops on the device; the host
reads the level count and the counts once a launch.  A launch holds at
most ``levels_per_launch`` levels (the size of its count array): a deeper
propagation goes on in a further launch from the words the last one left.
:func:`or_pull` is one level over one word, the same kernel.

Words are int64 tensors holding the 64 bits as they are (bit 63 is the
sign).  CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from webgraph_tpu_torch.kernels import _build

KMAX = 16      # words a node in one launch
LEVELS = 1024  # levels a launch: the size of its count array
_EMAX = 10     # bounds[e] counts in-degree <= 2**e; the kernel reads e <= 9


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """uint8[n, 64]: bit ``b`` of ``words[x]`` at ``[x, b]`` (a shift then a
    mask, so bit 63 does not sign-extend)."""
    shifts = torch.arange(64, device=words.device)
    return ((words.unsqueeze(1) >> shifts) & 1).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64[n] from uint8[n, 64] of 0/1 (the inverse of
    :func:`unpack_bits`): a sum of distinct powers of two has no carries,
    and bit 63's power is int64's least value, so the sum is the word."""
    shifts = torch.arange(64, device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(dim=1)


def _in_targets(in_off: torch.Tensor) -> torch.Tensor:
    """The target node of each in-arc of the in-CSR."""
    n = in_off.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=in_off.device), in_off[1:] - in_off[:-1])


def pull_order(in_off: torch.Tensor):
    """``(order int32[n], bounds int64[_EMAX], span int64[n, 2])`` on
    ``in_off``'s device: the nodes sorted by in-degree (stable),
    ``bounds[e]`` the number of nodes of in-degree <= 2**e, and the in-arc
    range of each node in that order.  The kernel maps nodes to lanes by
    it; one sort a graph (``algo.device.DeviceCSR`` keeps it)."""
    deg = in_off[1:] - in_off[:-1]
    sdeg, order = torch.sort(deg, stable=True)
    edges = torch.ones(_EMAX, dtype=torch.int64, device=in_off.device) \
        << torch.arange(_EMAX, device=in_off.device)
    first = in_off[order]
    return (order.to(torch.int32),
            torch.searchsorted(sdeg, edges, right=True).to(torch.int64),
            torch.stack([first, first + sdeg], dim=1))


def or_pull_plain(in_off, in_src, old, *, perbit=False, dist=None, level=0):
    """:func:`or_pull` in plain PyTorch, on any device: the 64 bits of every
    word unpacked, a ``scatter_reduce(amax)`` over the in-arcs, packed
    again.  Returns ``(new, stats)``; writes ``dist`` in place."""
    n = old.numel()
    bits = unpack_bits(old)
    pulled = torch.zeros_like(bits)
    if in_src.numel():
        idx = _in_targets(in_off).unsqueeze(1).expand(-1, 64)
        pulled.scatter_reduce_(0, idx, bits[in_src.long()], "amax")
    now = bits | pulled
    nb = now & (1 - bits)
    stats = torch.zeros(65 if perbit else 1, dtype=torch.int64,
                        device=old.device)
    stats[0] = nb.sum(dtype=torch.int64)
    if perbit:
        stats[1:] = nb.sum(dim=0, dtype=torch.int64)
    new = pack_bits(now)
    if dist is not None and n:
        reached = (old == 0) & (new != 0)
        dist.masked_fill_(reached, level + 1)
    return new, stats


class Propagation(NamedTuple):
    """What :func:`propagate` returns."""

    words: torch.Tensor        # int64[n, k], on the words' device
    counts: torch.Tensor       # int64[levels, k] on the host: bits reached
    bits: torch.Tensor | None  # int64[levels, k, 64] on the device (perbit)
    levels: int                # levels run, the last the one that reached
    #                            nothing unless the cap stopped it first


def _check(in_off, in_src, words, dist, what, dims):
    """Raise ValueError unless the in-CSR, the ``dims``-d int64 words and
    ``dist`` (int32, the words' shape) are contiguous, on one device, of
    matching sizes."""
    dev = words.device
    if words.dtype != torch.int64 or words.dim() != dims \
            or not words.is_contiguous() or (dims == 2 and words.shape[1] < 1):
        shape = "[n]" if dims == 1 else "[n, k], k >= 1"
        raise ValueError(f"{what}: words must be a contiguous int64{shape} "
                         f"tensor, got {words.dtype}{tuple(words.shape)}")
    n = words.shape[0]
    for name, t, dtype, size in (("in_off", in_off, torch.int64, n + 1),
                                 ("in_src", in_src, torch.int32, None)):
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise ValueError(
                f"{what}: {name} must be a contiguous 1-d {dtype} tensor "
                f"of {size if size is not None else 'any'} elements on {dev}")
    if dist is not None and (dist.device != dev or dist.dtype != torch.int32
                             or dist.shape != words.shape
                             or not dist.is_contiguous()):
        raise ValueError(f"{what}: dist must be a contiguous int32 tensor "
                         f"of shape {tuple(words.shape)} on {dev}")


def _launch(in_src, order, src, a, b, stat, perbit, dist, level0, cap):
    """One launch of ``or_pull`` (up to ``cap`` levels from ``src``)."""
    n, k = src.shape
    lib = _build.load()
    dev = src.device
    with torch.cuda.device(dev):
        rc = lib.wgt_or_pull(
            in_src.data_ptr(), order[0].data_ptr(), order[1].data_ptr(),
            order[2].data_ptr(), n, k, src.data_ptr(), a.data_ptr(),
            b.data_ptr(), stat.data_ptr(), int(perbit),
            dist.data_ptr() if dist is not None else None, int(level0),
            int(cap), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_or_pull", rc)
    or_pull.launches += 1


def _levels_plain(in_off, in_src, perbit, dist):
    """A step of :func:`_drive` by :func:`or_pull_plain`, word by word."""

    def step(words, cap, level0):
        counts, bits = [], []
        for t in range(cap):
            cols, stats = [], []
            for j in range(words.shape[1]):
                new, st = or_pull_plain(
                    in_off, in_src, words[:, j].contiguous(), perbit=perbit,
                    dist=None if dist is None else dist[:, j],
                    level=level0 + t)
                cols.append(new)
                stats.append(st)
            words = torch.stack(cols, dim=1)
            st = torch.stack(stats)
            counts.append(st[:, 0])
            bits.append(st[:, 1:])
            if int(st[:, 0].sum()) == 0:
                break
        return (words, torch.stack(counts).cpu(),
                torch.stack(bits) if perbit else None, len(counts))

    return step


def _levels_kernel(in_src, order, words, perbit, dist):
    """A step of :func:`_drive` by one launch of ``or_pull``: ping-pong
    buffers ``x``, ``y`` (the first launch reads ``words``; a further one
    reads the buffer the last one left and writes the other first)."""
    n, k = words.shape
    x, y = torch.empty_like(words), torch.empty_like(words)

    def step(src, cap, level0):
        a, b = (x, y) if src is words else ((y, x) if src is x else (x, y))
        stat = torch.zeros(2 + cap * k * (65 if perbit else 1),
                           dtype=torch.int64, device=words.device)
        _launch(in_src, order, src, a, b, stat, perbit, dist, level0, cap)
        head = stat[: 2 + cap * k].cpu()  # the launch's one host read
        run = int(head[0])
        counts = head[2: 2 + run * k].view(run, k)
        bits = stat[2 + cap * k:].view(cap, k, 64)[:run] if perbit else None
        return (a if run % 2 else b), counts, bits, run

    return step


def _drive(step, words, max_levels, per_launch, perbit):
    """Level arrays of ``per_launch`` levels until a level reaches nothing
    or ``max_levels`` have run: ``step(words, cap, level0) -> (words,
    counts, bits, run)``, one host read each (:attr:`propagate.reads`)."""
    n, k = words.shape
    if max_levels < 0 or per_launch < 1:
        raise ValueError("propagate: max_levels must be >= 0 and "
                         "levels_per_launch >= 1")
    out, counts, bits, done = words, [], [], 0
    while done < max_levels:
        out, c, b, run = step(out, min(per_launch, max_levels - done), done)
        propagate.reads += 1
        counts.append(c)
        bits.append(b)
        done += run
        if not c[-1].any():
            break
    propagate.levels += done
    if out is words:
        out = words.clone()
    if len(counts) == 1:  # one level array, the common case
        cnt, bits = counts[0], bits[0]
    elif counts:
        cnt = torch.cat(counts)
        bits = torch.cat(bits) if perbit else None
    else:
        cnt = torch.zeros(0, k, dtype=torch.int64)
        bits = torch.zeros(0, k, 64, dtype=torch.int64,
                           device=words.device) if perbit else None
    return Propagation(out, cnt, bits, done)


def propagate_plain(in_off, in_src, words, *, max_levels, perbit=False,
                    dist=None, levels_per_launch=LEVELS):
    """:func:`propagate` in plain PyTorch, on any device: :func:`or_pull_plain`
    level by level and word by word."""
    _check(in_off, in_src, words, dist, "propagate", 2)
    return _drive(_levels_plain(in_off, in_src, perbit, dist), words,
                  int(max_levels), int(levels_per_launch), perbit)


def propagate(in_off, in_src, words, *, max_levels, perbit=False, dist=None,
              levels_per_launch=LEVELS, order=None):
    """Reachability over the in-CSR ``(in_off int64[n+1], in_src
    int32[m])`` from ``words`` (int64[n, k], not written), level after
    level until a level reaches nothing in any word or ``max_levels`` have
    run.  Returns a :class:`Propagation`: the words, the bits each word
    reached at each level (on the host), with ``perbit`` the nodes each
    bit reached (on the device), and the levels run.  ``dist`` (int32[n,
    k], optional) gets ``level + 1`` where a word turns non-zero at level
    ``level`` (levels from 0).  ``order``: :func:`pull_order` of
    ``in_off``, made here when not given.

    CPU tensors take :func:`propagate_plain`.  CUDA tensors launch
    ``or_pull`` (``csrc/propagate.cu``) once a ``levels_per_launch``
    levels, counted in ``or_pull.launches``, each followed by one host read
    (``propagate.reads``); ``k`` past :data:`KMAX`, or a cooperative launch
    the card refuses, raises."""
    dev = words.device
    if dev.type == "cpu":
        return propagate_plain(in_off, in_src, words, max_levels=max_levels,
                               perbit=perbit, dist=dist,
                               levels_per_launch=levels_per_launch)
    if dev.type != "cuda":
        raise ValueError(f"propagate: unsupported device {dev}")
    _check(in_off, in_src, words, dist, "propagate", 2)
    if words.shape[1] > KMAX:
        raise ValueError(f"propagate: at most {KMAX} words a node in a "
                         f"launch, got {words.shape[1]}")
    if order is None:
        order = pull_order(in_off)
    return _drive(_levels_kernel(in_src, order, words, perbit, dist),
                  words, int(max_levels), int(levels_per_launch), perbit)


propagate.reads = 0   # host reads: one a launch (a level array)
propagate.levels = 0  # levels run


def or_pull(in_off, in_src, old, *, perbit=False, dist=None, level=0):
    """One level of reachability over the in-CSR ``(in_off int64[n+1],
    in_src int32[m])`` from the words ``old`` (int64[n]).

    Returns ``(new int64[n], stats int64[65 or 1])``: ``stats[0]`` counts
    the bits reached at this level, ``stats[1:]`` (with ``perbit``) the
    nodes each of the 64 bits reached.  ``dist`` (int32[n], optional) gets
    ``level + 1`` at every node whose word turns non-zero.  ``old`` is not
    written.  CPU tensors take :func:`or_pull_plain`; CUDA tensors launch
    ``or_pull`` (``csrc/propagate.cu``) once for one level over one word
    (after a sort of the nodes by in-degree, :func:`pull_order`), counted
    in ``or_pull.launches``, and read nothing back."""
    dev = old.device
    _check(in_off, in_src, old, dist, "or_pull", 1)
    if dev.type == "cpu":
        return or_pull_plain(in_off, in_src, old, perbit=perbit, dist=dist,
                             level=level)
    if dev.type != "cuda":
        raise ValueError(f"or_pull: unsupported device {dev}")
    stat = torch.zeros(2 + (65 if perbit else 1), dtype=torch.int64,
                       device=dev)
    new = torch.empty_like(old)
    _launch(in_src, pull_order(in_off), old.view(-1, 1), new.view(-1, 1),
            new.view(-1, 1), stat, perbit,
            None if dist is None else dist.view(-1, 1), level, 1)
    return new, stat[2:]


or_pull.launches = 0
