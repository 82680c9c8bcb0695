"""``or_pull``: one step of 64-source reachability by pull over an in-CSR,
its plain PyTorch version and its wrapper.

A node's word holds one bit a source (source ``i`` of a batch at bit
``i``).  One step computes, from ``old`` into a new buffer::

    new[x] = old[x] | OR of old[y] over the in-arcs y -> x
    nb[x]  = new[x] & ~old[x]                 (the bits reached at this step)
    stats[0]     = sum of popcount(nb[x])
    stats[1 + b] = #{x : bit b of nb[x]}      (with ``perbit``)
    dist[x] = level + 1 where old[x] == 0 and new[x] != 0   (with ``dist``)

It serves ``algo/device.py``: a level of BFS, an iteration of exact NF and
of geometric centralities.  It takes the place of the JAX package's
segmented-OR scan (``webgraph_tpu/algo/device.py::_seg_or_scan``), which
exists because XLA has no scatter-OR; PyTorch has none either, and no
population count, so the port computes the step in ``csrc/propagate.cu``.

Words are int64 tensors holding the 64 bits as they are (bit 63 is the
sign).  CPU tensors take :func:`or_pull_plain`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from webgraph_tpu_torch.kernels import _build


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


def _check(in_off, in_src, old, dist):
    dev = old.device
    n = old.numel()
    for name, t, dtype, size in (("in_off", in_off, torch.int64, n + 1),
                                 ("in_src", in_src, torch.int32, None),
                                 ("old", old, torch.int64, n)):
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise ValueError(
                f"or_pull: {name} must be a contiguous 1-d {dtype} tensor "
                f"of {size if size is not None else 'any'} elements on {dev}")
    if dist is not None and (dist.device != dev or dist.dtype != torch.int32
                             or dist.shape != (n,)
                             or not dist.is_contiguous()):
        raise ValueError(f"or_pull: dist must be a contiguous int32[{n}] "
                         f"tensor on {dev}")


def or_pull(in_off, in_src, old, *, perbit=False, dist=None, level=0):
    """One step of reachability over the in-CSR ``(in_off int64[n+1],
    in_src int32[m])`` from the words ``old`` (int64[n]).

    Returns ``(new int64[n], stats int64[65 or 1])``: ``stats[0]`` counts
    the bits reached at this step, ``stats[1:]`` (with ``perbit``) the nodes
    each of the 64 bits reached.  ``dist`` (int32[n], optional) gets
    ``level + 1`` at every node whose word turns non-zero.  ``old`` is not
    written.  CPU tensors take :func:`or_pull_plain`; CUDA tensors launch
    ``or_pull`` (``csrc/propagate.cu``) once, counted in
    ``or_pull.launches``."""
    dev = old.device
    _check(in_off, in_src, old, dist)
    if dev.type == "cpu":
        return or_pull_plain(in_off, in_src, old, perbit=perbit, dist=dist,
                             level=level)
    if dev.type != "cuda":
        raise ValueError(f"or_pull: unsupported device {dev}")
    new = torch.empty_like(old)
    stats = torch.zeros(65 if perbit else 1, dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_or_pull(
            in_off.data_ptr(), in_src.data_ptr(), old.numel(),
            old.data_ptr(), new.data_ptr(), stats.data_ptr(), int(perbit),
            dist.data_ptr() if dist is not None else None, int(level),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_or_pull", rc)
    if old.numel():
        or_pull.launches += 1
    return new, stats


or_pull.launches = 0
