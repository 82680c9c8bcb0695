"""Bulk BVGraph decode into CSR on a torch device.

Counterpart of ``BVGraph.to_csr(backend="device")`` and
``webgraph_tpu/pallas/decode2.py::decode_to_csr(_auto)``.  The stored graph
is loaded by the shared loader (``webgraph_tpu.formats.bvgraph``); the host
structure scan (``webgraph_tpu.pallas.plan.scan_structure``) and the lane
plan run on the host; the stream, the bit offsets and the plan go to the
device once; every tile of the plan is decoded by K1
(:func:`webgraph_tpu_torch.kernels.decode2.decode_lanes`) and its slab is
gathered into CSR on the device.

Graphs that K1 does not support (GOLOMB or NIBBLE codings, window above 7,
reference chains reaching back more than 256 nodes) raise
NotImplementedError: their device path arrives with the port of the
block-phase kernel (K2), and their host path is
``webgraph_tpu.formats.bvgraph_np``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from webgraph_tpu.pallas.plan import scan_structure
from webgraph_tpu_torch.kernels import decode2 as D2


@dataclass
class Prepared:
    """A graph planned for decoding on one device."""

    device: torch.device
    tiles: list            # D2.LanePlan per tile
    inputs: list           # D2.LaneInputs per tile, on the device
    prows: list            # each tile's prow on the device
    exp_wps: list          # each tile's expected emission counts (int32)
    words: torch.Tensor    # stream words (int64 bit patterns)
    bo: torch.Tensor       # node bit offsets (int64, n + 1)
    outdegrees: torch.Tensor  # int64 (n,)
    offsets: torch.Tensor  # CSR offsets (int64, n + 1)
    bases: list            # each tile's first CSR position
    skey: tuple


def prepare(g, device="cpu", *, tile_arcs: int | None = None) -> Prepared:
    """Scan, plan and move to ``device`` everything a decode needs.

    One plan covers the graph when it fits one launch; otherwise (or when
    ``tile_arcs`` is given) the graph is cut into arc-balanced tiles."""
    if not D2.supports(g):
        s = g.settings
        raise NotImplementedError(
            f"K1 does not decode this graph (codings {s.flags_string()!r}, "
            f"window {s.window_size}, maxref {s.max_ref_count}); its device "
            f"path arrives with the K2 port (ROADMAP A.5), its host path is "
            f"webgraph_tpu.formats.bvgraph_np.decode_to_csr")
    device = torch.device(device)
    scan = scan_structure(g)
    if tile_arcs is None:
        try:
            tiles = [D2.plan_lanes(g, scan)]
        except ValueError:
            tiles = D2.plan_tiles(g, scan)
    else:
        tiles = D2.plan_tiles(g, scan, tile_arcs=tile_arcs)
    d = scan.d.astype(np.int64)
    offsets = np.zeros(len(d) + 1, dtype=np.int64)
    np.cumsum(d, out=offsets[1:])
    return Prepared(
        device=device,
        tiles=tiles,
        inputs=[D2.LaneInputs.of(p, device) for p in tiles],
        prows=[p.prow.to(device) for p in tiles],
        exp_wps=[p.exp_wp.to(device=device, dtype=torch.int32) for p in tiles],
        words=D2.stream_words(g, device),
        bo=torch.from_numpy(np.asarray(g.bit_offsets, np.int64)).to(device),
        outdegrees=torch.from_numpy(d).to(device),
        offsets=torch.from_numpy(offsets).to(device),
        bases=[int(offsets[p.lo]) for p in tiles],
        skey=D2.coding_key(g.settings),
    )


def decode_prepared(prep: Prepared) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a prepared graph: ``(offsets int64[n+1], successors
    int32[m])`` on the prepared device."""
    off, dd = prep.offsets, prep.outdegrees
    succ = torch.empty(sum(p.m for p in prep.tiles), dtype=torch.int32,
                       device=prep.device)
    for plan, li, prow, exp_wp, base in zip(
            prep.tiles, prep.inputs, prep.prows, prep.exp_wps, prep.bases):
        slab, wp = D2.decode_lanes(prep.words, prep.bo, li, prep.skey)
        if not torch.equal(wp, exp_wp):
            bad = torch.nonzero(wp != exp_wp).flatten()[:8]
            raise AssertionError(
                f"lane emission counts off at lanes {bad.tolist()} (tile "
                f"[{plan.lo}, {plan.hi})): {wp[bad].tolist()} vs "
                f"{exp_wp[bad].tolist()}")
        lo, hi, mt = plan.lo, plan.hi, plan.m
        # ragged gather: node x's list lives at slab[prow[x - lo] ...]
        dl = dd[lo:hi]
        take = torch.repeat_interleave(prow[:hi - lo], dl, output_size=mt) + (
            torch.arange(mt, device=prep.device)
            - torch.repeat_interleave(off[lo:hi] - off[lo], dl,
                                      output_size=mt))
        succ[base:base + mt] = slab.reshape(-1)[take]
    return off, succ


def decode_to_csr(g, device="cpu", *, tile_arcs: int | None = None):
    """Decode ``g`` on ``device``: ``(offsets int64[n+1], successors
    int32[m])`` as tensors there, equal to ``bvgraph_np.decode_to_csr``.

    A CUDA device runs the K1 kernel; the CPU runs its plain PyTorch
    version.  Raises NotImplementedError for graphs K1 does not support."""
    return decode_prepared(prepare(g, device, tile_arcs=tile_arcs))


def to_csr(g, device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """``BVGraph.to_csr(backend="device")`` on a torch device: the decoded
    CSR as host numpy arrays."""
    off, succ = decode_to_csr(g, device)
    return off.cpu().numpy(), succ.cpu().numpy()
