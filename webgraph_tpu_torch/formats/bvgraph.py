"""BVGraph — the Boldi-Vigna compressed graph format, and its bulk decode
on a torch device.

The format half is a copy of the JAX package's ``formats/bvgraph.py`` (the
scalar oracle codec, re-implemented from BVGraph.java:121-291 for the
format, :1032-1133 for random-access decode, :1136-1281 for sequential
decode, :2049-2219 for differential compression, :2276-2360 for the greedy
reference-selection loop):

* per-node records: outdegree, reference + copy-block list, intervalized
  extras, gap-coded residuals — each component under a configurable
  instantaneous code (gamma/delta/zeta_k/unary/Golomb/nibble);
* ``.graph`` successor bitstream, ``.offsets`` delta-coded bit offsets,
  ``.properties`` metadata (format-compatible with the reference so graphs
  are interchangeable on disk, and with the JAX package's files).

The decode half (:func:`prepare`, :func:`decode_prepared`,
:func:`decode_to_csr`, :func:`to_csr`) is the counterpart of the JAX
package's ``pallas/decode2.py::decode_to_csr_auto``.  The host structure
scan (``kernels/plan.py``) routes a graph to K1 (``kernels/decode2.py``:
a record-parallel parse that gives long records a block each) when its
reference chains reach back at most 256 nodes, else to K2
(``kernels/decode.py``: a parse of a thread a record).  Both then resolve
the copy chains in one persistent launch, decode straight into CSR and
read γ, δ, ζ and unary codes with window <= 7; any other graph raises
NotImplementedError, and its host path is
:func:`webgraph_tpu_torch.formats.bvgraph_np.decode_to_csr`.  The entry
points run on the card unless the caller passes ``device="cpu"``, where
the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import (
    InputBitStream,
    MappedWords,
    OutputBitStream,
    as_u64_words,
    bytes_to_words,
)
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph, NodeIterator
from webgraph_tpu_torch.graph.properties import load_properties, store_properties
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.timing import span

GRAPH_EXTENSION = ".graph"
OFFSETS_EXTENSION = ".offsets"
PROPERTIES_EXTENSION = ".properties"
OUTDEGREES_EXTENSION = ".outdegrees"
OFFSETS_CACHE_EXTENSION = ".obl.npy"  # our analog of the serialized .obl cache

#: minIntervalLength value meaning "no intervalization" (reference NO_INTERVALS).
NO_INTERVALS = 0

DEFAULT_WINDOW_SIZE = 7
DEFAULT_MAX_REF_COUNT = 3
DEFAULT_MIN_INTERVAL_LENGTH = 4
DEFAULT_ZETA_K = 3

# Flag-mask slots (4 bits per component; reference BVGraph.java:474-544).
_FLAG_SLOTS = {
    "OUTDEGREES": 0,
    "BLOCKS": 4,
    "RESIDUALS": 8,
    "REFERENCES": 12,
    "BLOCK_COUNT": 16,
    "OFFSETS": 20,
}
_DEFAULT_CODINGS = {
    "OUTDEGREES": C.GAMMA,
    "BLOCKS": C.GAMMA,
    "RESIDUALS": C.ZETA,
    "REFERENCES": C.UNARY,
    "BLOCK_COUNT": C.GAMMA,
    "OFFSETS": C.GAMMA,
}


@dataclass(frozen=True)
class BVGraphSettings:
    """Compression parameters + per-component code assignment."""

    window_size: int = DEFAULT_WINDOW_SIZE
    max_ref_count: int = DEFAULT_MAX_REF_COUNT
    min_interval_length: int = DEFAULT_MIN_INTERVAL_LENGTH
    zeta_k: int = DEFAULT_ZETA_K
    codings: dict = field(default_factory=lambda: dict(_DEFAULT_CODINGS))

    @property
    def outdegree_coding(self) -> int:
        return self.codings["OUTDEGREES"]

    @property
    def block_coding(self) -> int:
        return self.codings["BLOCKS"]

    @property
    def residual_coding(self) -> int:
        return self.codings["RESIDUALS"]

    @property
    def reference_coding(self) -> int:
        return self.codings["REFERENCES"]

    @property
    def block_count_coding(self) -> int:
        return self.codings["BLOCK_COUNT"]

    @property
    def offset_coding(self) -> int:
        return self.codings["OFFSETS"]

    def flags_string(self) -> str:
        """Non-default codings as COMPONENT_CODENAME joined by '|'
        (reference flags2String, BVGraph.java:1331-1352)."""
        parts = []
        for comp, coding in self.codings.items():
            if coding != _DEFAULT_CODINGS[comp]:
                parts.append(f"{comp}_{C.CODING_NAME[coding]}")
        return " | ".join(parts)

    @classmethod
    def from_flags_string(cls, s: str, **kwargs) -> "BVGraphSettings":
        codings = dict(_DEFAULT_CODINGS)
        s = s.strip()
        if s:
            for part in s.split("|"):
                part = part.strip()
                comp, _, codename = part.rpartition("_")
                # component names themselves contain underscores (BLOCK_COUNT)
                while comp not in _FLAG_SLOTS and "_" in comp:
                    comp2, _, code2 = comp.rpartition("_")
                    codename = f"{code2}_{codename}"
                    comp = comp2
                if comp not in _FLAG_SLOTS or codename not in C.CODING_NAME:
                    raise ValueError(f"bad compression flag {part!r}")
                codings[comp] = C.CODING_NAME.index(codename)
        return cls(codings=codings, **kwargs)

    def flags_mask(self) -> int:
        mask = 0
        for comp, coding in self.codings.items():
            if coding != _DEFAULT_CODINGS[comp]:
                mask |= coding << _FLAG_SLOTS[comp]
        return mask

    @classmethod
    def from_flags_mask(cls, mask: int, **kwargs) -> "BVGraphSettings":
        codings = dict(_DEFAULT_CODINGS)
        for comp, shift in _FLAG_SLOTS.items():
            v = (mask >> shift) & 0xF
            if v != 0:
                codings[comp] = v
        return cls(codings=codings, **kwargs)


class BVGraph(ImmutableGraph):
    """A graph stored in BVGraph format, decoded lazily from the bitstream."""

    def __init__(
        self,
        words: np.ndarray,
        bit_length: int,
        n: int,
        m: int,
        settings: BVGraphSettings,
        offsets: np.ndarray | None = None,
        basename: str | None = None,
    ):
        self._words = words
        self._bit_length = bit_length
        self._n = n
        self._m = m
        self.settings = settings
        self._offsets_ef = None  # succinct resident index (EliasFanoMonotoneList)
        self.bit_offsets = offsets
        self._basename = basename
        self._ibs: InputBitStream | None = None

    # ------------------------------------------------------------------
    # Offsets index: resident storage is a succinct Elias-Fano monotone
    # list (reference: EliasFanoMonotoneLongBigList, BVGraph.java:81,1594);
    # random access queries it directly, bulk decoders materialize a
    # transient dense array via the property.
    # ------------------------------------------------------------------

    @property
    def bit_offsets(self):
        """Dense int64[n+1] bit offsets (materialized on demand from the
        succinct index), or None for sequential-only loads."""
        if self._offsets_ef is None:
            return None
        return self._offsets_ef.get_array()

    @bit_offsets.setter
    def bit_offsets(self, v):
        if v is None:
            self._offsets_ef = None
        else:
            from webgraph_tpu_torch.bits.elias_fano import EliasFanoMonotoneList

            self._offsets_ef = EliasFanoMonotoneList(np.asarray(v, dtype=np.int64))

    def _offset(self, x: int) -> int:
        """Bit offset of node x's record (one succinct-index query)."""
        return int(self._offsets_ef.get(x))

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @classmethod
    def load(cls, basename: str | os.PathLike, load_offsets: bool = True) -> "BVGraph":
        props = load_properties(f"{basename}{PROPERTIES_EXTENSION}")
        if int(props.get("version", 0)) > 0:
            raise ValueError(f"unsupported BVGraph version {props['version']}")
        settings = BVGraphSettings.from_flags_string(
            props.get("compressionflags", ""),
            window_size=int(props.get("windowsize", DEFAULT_WINDOW_SIZE)),
            max_ref_count=int(props.get("maxrefcount", DEFAULT_MAX_REF_COUNT)),
            min_interval_length=int(props.get("minintervallength", DEFAULT_MIN_INTERVAL_LENGTH)),
            zeta_k=int(props.get("zetak", DEFAULT_ZETA_K)),
        )
        with open(f"{basename}{GRAPH_EXTENSION}", "rb") as f:
            data = f.read()
        words = bytes_to_words(data)
        g = cls(
            words,
            8 * len(data),
            int(props["nodes"]),
            int(props["arcs"]),
            settings,
            basename=str(basename),
        )
        if load_offsets:
            g.bit_offsets = cls._load_offsets(basename, g)
        return g

    @classmethod
    def load_mapped(cls, basename):
        """Memory-mapped load: the ``.graph`` file stays off the heap and is
        paged in on access (reference loadMapped / ByteBufferInputStream.map,
        BVGraph.java:1551-1554).  Random-access decoding reads straight from
        the mapping; bulk vectorized/device decodes materialize the words
        once (they read the whole stream by nature)."""
        props = load_properties(f"{basename}{PROPERTIES_EXTENSION}")
        if int(props.get("version", 0)) > 0:
            raise ValueError(f"unsupported BVGraph version {props['version']}")
        settings = BVGraphSettings.from_flags_string(
            props.get("compressionflags", ""),
            window_size=int(props.get("windowsize", DEFAULT_WINDOW_SIZE)),
            max_ref_count=int(props.get("maxrefcount", DEFAULT_MAX_REF_COUNT)),
            min_interval_length=int(props.get("minintervallength", DEFAULT_MIN_INTERVAL_LENGTH)),
            zeta_k=int(props.get("zetak", DEFAULT_ZETA_K)),
        )
        buf = np.memmap(f"{basename}{GRAPH_EXTENSION}", dtype=np.uint8, mode="r")
        g = cls(
            MappedWords(buf),
            8 * len(buf),
            int(props["nodes"]),
            int(props["arcs"]),
            settings,
            basename=str(basename),
        )
        g.bit_offsets = cls._load_offsets(basename, g)
        return g

    @classmethod
    def load_sequential(cls, basename):
        return cls.load(basename, load_offsets=False)

    @classmethod
    def load_offline(cls, basename):
        return cls.load(basename, load_offsets=False)

    @staticmethod
    def _load_offsets(basename, g: "BVGraph") -> np.ndarray:
        """Decode the ``.offsets`` stream (coded per-node bit-length deltas;
        reference OffsetsLongIterator, BVGraph.java:907-935), with an ``.npy``
        cache in the role of the serialized ``.obl``."""
        off_path = f"{basename}{OFFSETS_EXTENSION}"
        cache_path = f"{basename}{OFFSETS_CACHE_EXTENSION}"
        if os.path.exists(cache_path) and os.path.getmtime(cache_path) >= os.path.getmtime(off_path):
            return np.load(cache_path)
        with open(off_path, "rb") as f:
            data = f.read()
        n = g.num_nodes()
        coding, k = g.settings.offset_coding, g.settings.zeta_k
        offsets = None
        try:
            from webgraph_tpu_torch import native

            offsets = native.decode_offsets(data, n + 1, coding, k)
        except ImportError:
            pass
        if offsets is None:
            ibs = InputBitStream(data)
            deltas = np.zeros(n + 1, dtype=np.int64)
            for i in range(n + 1):
                deltas[i] = ibs.read(coding, k)
            offsets = np.cumsum(deltas)
        try:
            np.save(cache_path, offsets)
        except OSError:
            pass
        return offsets

    # ------------------------------------------------------------------
    # Core accessors
    # ------------------------------------------------------------------

    def num_nodes(self) -> int:
        return self._n

    def num_arcs(self) -> int:
        return self._m

    def random_access(self) -> bool:
        return self._offsets_ef is not None

    def _stream(self) -> InputBitStream:
        return InputBitStream(self._words, self._bit_length)

    def outdegree(self, x: int) -> int:
        if not 0 <= x < self._n:
            raise IndexError(f"node {x} out of range")
        if self._offsets_ef is None:
            raise RuntimeError("outdegree of a random node requires offsets")
        if self._ibs is None:
            self._ibs = self._stream()
        self._ibs.position(self._offset(x))
        return self._ibs.read(self.settings.outdegree_coding, self.settings.zeta_k)

    def successors(self, x: int) -> np.ndarray:
        """Random-access decode of one successor list, resolving reference
        chains recursively (reference BVGraph.successors, :1032-1133)."""
        if not 0 <= x < self._n:
            raise IndexError(f"node {x} out of range")
        if self._offsets_ef is None:
            raise RuntimeError("random access requires offsets")
        return self._decode_list(x, self._stream())

    successor_array = successors

    def _decode_list(self, x: int, ibs: InputBitStream) -> np.ndarray:
        s = self.settings
        ibs.position(self._offset(x))
        d = ibs.read(s.outdegree_coding, s.zeta_k)
        if d == 0:
            return np.zeros(0, dtype=np.int32)
        ref = ibs.read(s.reference_coding, s.zeta_k) if s.window_size > 0 else -1
        blocks: list[int] = []
        copied = 0
        if ref > 0:
            block_count = ibs.read(s.block_count_coding, s.zeta_k)
            total = 0
            for i in range(block_count):
                b = ibs.read(s.block_coding, s.zeta_k) + (0 if i == 0 else 1)
                blocks.append(b)
                total += b
                if (i & 1) == 0:
                    copied += b
            if (block_count & 1) == 0:
                # implicit tail copy: need the referenced node's outdegree
                ref_ibs = self._stream()
                ref_ibs.position(self._offset(x - ref))
                ref_outd = ref_ibs.read(s.outdegree_coding, s.zeta_k)
                copied += ref_outd - total
            extra_count = d - copied
        else:
            extra_count = d

        left, lengths = self._read_intervals(ibs, x, extra_count)
        interval_len = sum(lengths)
        residual_count = extra_count - interval_len
        residuals = self._read_residuals(ibs, x, residual_count)

        parts = []
        if ref > 0:
            ref_list = self._decode_list(x - ref, self._stream())
            parts.append(_apply_blocks(ref_list, blocks))
        for l, ln in zip(left, lengths):
            parts.append(np.arange(l, l + ln, dtype=np.int32))
        if residual_count:
            parts.append(residuals)
        out = np.sort(np.concatenate(parts)) if parts else np.zeros(0, dtype=np.int32)
        assert len(out) == d, f"decoded {len(out)} successors for node {x}, expected {d}"
        return out

    def _read_intervals(self, ibs: InputBitStream, x: int, extra_count: int):
        s = self.settings
        left: list[int] = []
        lengths: list[int] = []
        if extra_count > 0 and s.min_interval_length != NO_INTERVALS:
            interval_count = ibs.read_gamma()
            if interval_count:
                prev = x + C.nat2int(ibs.read_long_gamma())
                left.append(prev)
                lengths.append(ibs.read_gamma() + s.min_interval_length)
                prev += lengths[0]
                for _ in range(1, interval_count):
                    l = ibs.read_gamma() + prev + 1
                    left.append(l)
                    lengths.append(ibs.read_gamma() + s.min_interval_length)
                    prev = l + lengths[-1]
        return left, lengths

    def _read_residuals(self, ibs: InputBitStream, x: int, residual_count: int) -> np.ndarray:
        s = self.settings
        out = np.zeros(residual_count, dtype=np.int32)
        if residual_count:
            prev = x + C.nat2int(ibs.read(s.residual_coding, s.zeta_k))
            out[0] = prev
            for i in range(1, residual_count):
                prev += ibs.read(s.residual_coding, s.zeta_k) + 1
                out[i] = prev
        return out

    # ------------------------------------------------------------------
    # Sequential decode
    # ------------------------------------------------------------------

    def node_iterator(self, start: int = 0) -> NodeIterator:
        return _BVGraphNodeIterator(self, start)

    def to_csr(self, backend: str | None = None,
               device="cuda") -> tuple[np.ndarray, np.ndarray]:
        """Bulk decode to host CSR, dispatched to a backend (the
        load-method dispatch analog of ImmutableGraph.java:647-685):

        * ``"device"`` — the port's kernels on the torch ``device`` (K1,
          else K2: :func:`to_csr` below);
        * ``"native"`` — the C++ host codec (host/wgt_codec.cpp);
        * ``"numpy"``  — the vectorized NumPy lane decoder;
        * ``"scalar"`` — the bitstream oracle (always available);
        * ``None``/``"auto"`` — device when ``device`` is a CUDA device
          that is present and a kernel decodes the graph, else native ->
          numpy -> scalar.  Overridable with the ``WGT_DECODE_BACKEND``
          env var.
        """
        if backend is None:
            backend = os.environ.get("WGT_DECODE_BACKEND", "auto")
        if backend == "auto":
            on_card = (torch.device(device).type == "cuda"
                       and torch.cuda.is_available())
            backend = "device" if on_card and K2.supports(self) else "host"
        if backend == "device":
            return to_csr(self, device)
        if backend in ("host", "native"):
            try:
                from webgraph_tpu_torch import native
                from webgraph_tpu_torch.bits.bitstream import words_to_bytes

                if native.available():
                    data = words_to_bytes(as_u64_words(self._words),
                                          self._bit_length)
                    out = native.bvgraph_decode(data, self._n, self._m,
                                                self.settings)
                    if out is not None:
                        return out
            except ImportError:
                pass
            if backend == "native":
                raise RuntimeError("native codec unavailable")
            backend = "numpy"
        if backend == "numpy":
            try:
                from webgraph_tpu_torch.formats import bvgraph_np

                return bvgraph_np.decode_to_csr(self)
            except (ImportError, NotImplementedError):
                return self._to_csr_scalar()
        if backend == "scalar":
            return self._to_csr_scalar()
        raise ValueError(f"unknown decode backend {backend!r}")

    def _to_csr_scalar(self) -> tuple[np.ndarray, np.ndarray]:
        offsets = np.zeros(self._n + 1, dtype=np.int64)
        chunks = []
        it = self.node_iterator()
        while it.has_next():
            x = it.next_int()
            succ = it.successor_array()
            offsets[x + 1] = len(succ)
            chunks.append(succ)
        np.cumsum(offsets, out=offsets)
        succ = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)
        return offsets, succ.astype(np.int32)

    # ------------------------------------------------------------------
    # Store (compression) — scalar oracle encoder
    # ------------------------------------------------------------------

    @classmethod
    def store(
        cls,
        graph: ImmutableGraph,
        basename: str | os.PathLike,
        window_size: int = -1,
        max_ref_count: int = -1,
        min_interval_length: int = -1,
        zeta_k: int = -1,
        settings: BVGraphSettings | None = None,
        num_shards: int = 1,
        comment: str = "BVGraph properties",
        use_native: bool | str = "auto",
        pl=None,
    ) -> dict:
        """Compress ``graph`` to BVGraph files; returns the stats dict
        (mirrors BVGraph.store -> storeInternal, BVGraph.java:1679,2436-2650).

        ``num_shards > 1`` mirrors the reference's multithreaded compression:
        the node range is split, each shard compresses with a fresh reference
        window, and the shard bitstreams are bit-concatenated.
        """
        s = settings or BVGraphSettings()
        if window_size != -1:
            s = replace(s, window_size=window_size)
        if max_ref_count != -1:
            s = replace(s, max_ref_count=max_ref_count)
        if min_interval_length != -1:
            s = replace(s, min_interval_length=min_interval_length)
        if zeta_k != -1:
            s = replace(s, zeta_k=zeta_k)

        if use_native == "auto" or use_native is True:
            native_result = cls._store_native(graph, basename, s, num_shards, comment)
            if native_result is not None:
                return native_result
            if use_native is True:
                raise RuntimeError("native encoder unavailable")

        graph_obs = OutputBitStream()
        offsets_obs = OutputBitStream()
        stats = _CompressionStats()

        try:
            n_known = graph.num_nodes()
        except (NotImplementedError, TypeError):
            # sequential-only sources (e.g. IncrementalImmutableSequentialGraph)
            n_known = None
            num_shards = 1
        if num_shards <= 1:
            iterators = [graph.node_iterator()]
        else:
            iterators = graph.split_node_iterators(num_shards)

        if pl is not None:
            try:
                pl.expected_updates = graph.num_nodes()
            except (NotImplementedError, TypeError):
                pass
            pl.start("compressing")
        for it in iterators:
            _compress_shard(it, s, graph_obs, offsets_obs, stats, final=False, pl=pl)
        # final offset (total bit length delta from last node's start)
        _write_code(offsets_obs, s.offset_coding, s.zeta_k, graph_obs.written_bits - stats.last_offset)
        stats.last_offset = graph_obs.written_bits

        if pl is not None:
            pl.done()
        with open(f"{basename}{GRAPH_EXTENSION}", "wb") as f:
            f.write(graph_obs.to_bytes())
        with open(f"{basename}{OFFSETS_EXTENSION}", "wb") as f:
            f.write(offsets_obs.to_bytes())

        n = n_known if n_known is not None else stats.node_count
        return cls._write_properties(
            basename, n, s, stats, graph_obs.written_bits, offsets_obs.written_bits, comment
        )

    @classmethod
    def _store_native(cls, graph, basename, s, num_shards, comment) -> dict | None:
        """Fast path: the native C++ encoder (byte-identical output).

        ``num_shards > 1`` compresses node-range shards CONCURRENTLY on a
        thread pool (the ctypes calls release the GIL) and bit-concatenates
        the per-shard graph/offset streams in node order — the reference's
        CompressionThread + copyTo merge (BVGraph.java:2469-2550).  The
        result is byte-identical to the serial sharded Python encoder
        (each shard starts a fresh reference window)."""
        try:
            from webgraph_tpu_torch import native
        except ImportError:
            return None
        if not native.available():
            return None
        try:
            n = graph.num_nodes()
        except (NotImplementedError, TypeError):
            return None
        offsets, succ = graph.to_csr()
        if num_shards <= 1:
            out = native.bvgraph_encode(offsets, succ, s)
            if out is None:
                return None
            graph_bytes, gbits, off_bytes, obits, raw = out
        else:
            from concurrent.futures import ThreadPoolExecutor

            # identical bounds to split_node_iterators (immutable_graph.py)
            # so native and Python sharded encodes are byte-identical for
            # every (n, num_shards), not just divisible ones
            bounds = np.array(
                [round(i * n / num_shards) for i in range(num_shards + 1)],
                dtype=np.int64)

            def enc(k):
                a, b = int(bounds[k]), int(bounds[k + 1])
                loc_off = offsets[a : b + 1] - offsets[a]
                return native.bvgraph_encode(
                    loc_off, succ[offsets[a] : offsets[b]], s,
                    first_node=a, skip_first_offset=k > 0)

            with ThreadPoolExecutor(max_workers=num_shards) as ex:
                parts = list(ex.map(enc, range(num_shards)))
            if any(p is None for p in parts):
                return None
            gobs = OutputBitStream()
            oobs = OutputBitStream()
            raw = np.zeros(76, dtype=np.int64)
            for gb, gbits_k, ob, obits_k, st in parts:
                gobs.append_raw(gb, gbits_k)
                oobs.append_raw(ob, obits_k)
                raw += st
            gbits, obits = gobs.written_bits, oobs.written_bits
            graph_bytes, off_bytes = gobs.to_bytes(), oobs.to_bytes()
        with open(f"{basename}{GRAPH_EXTENSION}", "wb") as f:
            f.write(graph_bytes)
        with open(f"{basename}{OFFSETS_EXTENSION}", "wb") as f:
            f.write(off_bytes)
        stats = _CompressionStats()
        (
            stats.bits_outdegrees,
            stats.bits_references,
            stats.bits_blocks,
            stats.bits_intervals,
            stats.bits_residuals,
            stats.copied_arcs,
            stats.intervalised_arcs,
            stats.residual_arcs,
            stats.tot_ref,
            stats.tot_dist,
        ) = (int(v) for v in raw[:10])
        stats.successor_gap_stats = raw[10:43].copy()
        stats.residual_gap_stats = raw[43:76].copy()
        stats.tot_links = int(offsets[-1])
        stats.node_count = n
        return cls._write_properties(basename, n, s, stats, gbits, obits, comment)

    @classmethod
    def _write_properties(cls, basename, n, s, stats, written, offset_bits, comment) -> dict:
        m = stats.tot_links
        props: dict[str, object] = {
            "version": 0,
            "graphclass": "it.unimi.dsi.webgraph.BVGraph",
            "nodes": n,
            "arcs": m,
            "minintervallength": s.min_interval_length,
            "maxrefcount": s.max_ref_count,
            "windowsize": s.window_size,
            "zetak": s.zeta_k,
            "compressionflags": s.flags_string(),
            "avgref": f"{stats.tot_ref / max(n, 1):.3f}",
            "avgdist": f"{stats.tot_dist / max(n, 1):.3f}",
            "copiedarcs": stats.copied_arcs,
            "intervalisedarcs": stats.intervalised_arcs,
            "residualarcs": stats.residual_arcs,
            "bitsperlink": f"{written / max(m, 1):.3f}",
            "compratio": f"{written / max(_lower_bound_bits(n, m), 1e-9):.3f}",
            "bitspernode": f"{written / max(n, 1):.3f}",
            "avgbitsforoutdegrees": f"{stats.bits_outdegrees / max(n, 1):.3f}",
            "avgbitsforreferences": f"{stats.bits_references / max(n, 1):.3f}",
            "avgbitsforblocks": f"{stats.bits_blocks / max(n, 1):.3f}",
            "avgbitsforintervals": f"{stats.bits_intervals / max(n, 1):.3f}",
            "avgbitsforresiduals": f"{stats.bits_residuals / max(n, 1):.3f}",
            "bitsforoutdegrees": stats.bits_outdegrees,
            "bitsforreferences": stats.bits_references,
            "bitsforblocks": stats.bits_blocks,
            "bitsforintervals": stats.bits_intervals,
            "bitsforresiduals": stats.bits_residuals,
            "graphbits": written,
            "offsetbits": offset_bits,
            "successoravggap": f"{stats.successor_avg_gap():.3f}",
            "residualavggap": f"{stats.residual_avg_gap():.3f}",
            "successoravgloggap": f"{stats.successor_avg_log_gap():.3f}",
            "residualavgloggap": f"{stats.residual_avg_log_gap():.3f}",
            "successorexpstats": stats.exp_stats(stats.successor_gap_stats),
            "residualexpstats": stats.exp_stats(stats.residual_gap_stats),
        }
        store_properties(f"{basename}{PROPERTIES_EXTENSION}", props, comment=comment)
        return props

    def write_offsets(self, basename: str | os.PathLike | None = None) -> None:
        """Regenerate the ``.offsets`` file from the graph stream
        (reference: BVGraph.main --offsets path)."""
        basename = basename or self._basename
        s = self.settings
        obs = OutputBitStream()
        prev = 0
        it = self.node_iterator()
        positions = self._node_start_bits()
        for p in positions:
            _write_code(obs, s.offset_coding, s.zeta_k, int(p) - prev)
            prev = int(p)
        del it
        with open(f"{basename}{OFFSETS_EXTENSION}", "wb") as f:
            f.write(obs.to_bytes())

    def _node_start_bits(self) -> np.ndarray:
        """Bit positions of every node record (plus end), by sequential scan."""
        it = _BVGraphNodeIterator(self, 0)
        out = np.zeros(self._n + 1, dtype=np.int64)
        i = 0
        while it.has_next():
            out[i] = it._ibs.pos
            it.next_int()
            i += 1
        out[self._n] = it._ibs.pos
        return out

    def write_outdegrees(self, basename: str | os.PathLike | None = None) -> None:
        """Write the gamma-coded ``.outdegrees`` stream
        (reference: BVGraph.java:2766-2775)."""
        basename = basename or self._basename
        obs = OutputBitStream()
        it = self.node_iterator()
        while it.has_next():
            it.next_int()
            obs.write_gamma(it.outdegree())
        with open(f"{basename}{OUTDEGREES_EXTENSION}", "wb") as f:
            f.write(obs.to_bytes())


def _apply_blocks(ref_list: np.ndarray, blocks: list[int]) -> np.ndarray:
    """Apply a copy/skip block mask to a reference successor list
    (reference MaskedIntIterator semantics, MaskedIntIterator.java:37)."""
    if not blocks:
        return ref_list
    keep = np.zeros(len(ref_list), dtype=bool)
    pos = 0
    copying = True
    for b in blocks:
        if copying:
            keep[pos : pos + b] = True
        pos += b
        copying = not copying
    if copying:  # tail is copied iff the block count is even
        keep[pos:] = True
    return ref_list[keep]


class _BVGraphNodeIterator(NodeIterator):
    """Sequential decoder with a cyclic window of fully decoded lists
    (reference BVGraphNodeIterator, BVGraph.java:1136-1281)."""

    def __init__(self, g: BVGraph, start: int, upper_bound: int | None = None):
        self.g = g
        self.s = g.settings
        self._n = g.num_nodes()
        self._bound = self._n if upper_bound is None else min(upper_bound, self._n)
        cbs = self.s.window_size + 1
        self._window: list[np.ndarray] = [np.zeros(0, dtype=np.int32)] * cbs
        self._outd = [0] * cbs
        self._ibs = g._stream()
        self._next = start
        self._curr = start - 1
        if start > 0:
            if g.bit_offsets is None:
                raise RuntimeError("starting a node iterator mid-graph requires offsets")
            # Prime the window with the preceding window_size lists via random
            # access (reference BVGraphNodeIterator(from != 0), :1173-1183).
            for y in range(max(0, start - self.s.window_size), start):
                lst = g.successors(y)
                self._window[y % cbs] = lst.astype(np.int32)
                self._outd[y % cbs] = len(lst)
            self._ibs.position(g._offset(start))

    def has_next(self) -> bool:
        return self._next < self._bound

    def next_int(self) -> int:
        if not self.has_next():
            raise StopIteration
        x = self._next
        self._next += 1
        self._curr = x
        s, g, ibs = self.s, self.g, self._ibs
        cbs = s.window_size + 1
        idx = x % cbs
        d = ibs.read(s.outdegree_coding, s.zeta_k)
        if d == 0:
            self._window[idx] = np.zeros(0, dtype=np.int32)
            self._outd[idx] = 0
            return x
        ref = ibs.read(s.reference_coding, s.zeta_k) if s.window_size > 0 else -1
        ref_idx = (x - ref) % cbs
        blocks: list[int] = []
        copied = 0
        if ref > 0:
            block_count = ibs.read(s.block_count_coding, s.zeta_k)
            total = 0
            for i in range(block_count):
                b = ibs.read(s.block_coding, s.zeta_k) + (0 if i == 0 else 1)
                blocks.append(b)
                total += b
                if (i & 1) == 0:
                    copied += b
            if (block_count & 1) == 0:
                copied += self._outd[ref_idx] - total
            extra_count = d - copied
        else:
            extra_count = d
        left, lengths = g._read_intervals(ibs, x, extra_count)
        residual_count = extra_count - sum(lengths)
        residuals = g._read_residuals(ibs, x, residual_count)
        parts = []
        if ref > 0:
            parts.append(_apply_blocks(self._window[ref_idx][: self._outd[ref_idx]], blocks))
        for l, ln in zip(left, lengths):
            parts.append(np.arange(l, l + ln, dtype=np.int32))
        if residual_count:
            parts.append(residuals)
        out = np.sort(np.concatenate(parts)) if parts else np.zeros(0, dtype=np.int32)
        assert len(out) == d, f"decoded {len(out)} successors for node {x}, expected {d}"
        self._window[idx] = out
        self._outd[idx] = d
        return x

    def outdegree(self) -> int:
        return self._outd[self._curr % (self.s.window_size + 1)]

    def successor_array(self) -> np.ndarray:
        return self._window[self._curr % (self.s.window_size + 1)]

    def copy(self, upper_bound: int) -> "_BVGraphNodeIterator":
        return _BVGraphNodeIterator(self.g, self._next, upper_bound)


# ----------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------


class _CompressionStats:
    def __init__(self):
        self.bits_outdegrees = 0
        self.bits_references = 0
        self.bits_blocks = 0
        self.bits_intervals = 0
        self.bits_residuals = 0
        self.copied_arcs = 0
        self.intervalised_arcs = 0
        self.residual_arcs = 0
        self.tot_links = 0
        self.tot_ref = 0
        self.tot_dist = 0
        self.last_offset = 0
        self.node_count = 0
        # exponential gap histograms (reference updateBins, BVGraph.java:1940-1944)
        self.successor_gap_stats = np.zeros(33, dtype=np.int64)
        self.residual_gap_stats = np.zeros(33, dtype=np.int64)

    @staticmethod
    def update_bins(node: int, lst: np.ndarray, bins: np.ndarray) -> None:
        if len(lst) == 0:
            return
        lst = np.asarray(lst, dtype=np.int64)
        first_gap = int(C.int2nat(int(lst[0]) - node))
        gaps = np.diff(lst)
        all_gaps = np.concatenate([[first_gap], gaps]) if len(gaps) else np.array([first_gap], dtype=np.int64)
        all_gaps = all_gaps[all_gaps > 0]
        if len(all_gaps):
            logs = np.floor(np.log2(all_gaps)).astype(np.int64)
            np.add.at(bins, logs, 1)

    @staticmethod
    def exp_stats(bins: np.ndarray) -> str:
        top = int(np.max(np.nonzero(bins)[0])) + 1 if bins.any() else 0
        return ",".join(str(int(v)) for v in bins[:top])

    def _avg_from_bins(self, bins: np.ndarray, log: bool) -> float:
        tot = bins.sum()
        if tot == 0:
            return 0.0
        idx = np.arange(len(bins))
        if log:
            return float((bins * (idx + 0.5)).sum() / tot)
        return float((bins * (2.0**idx * 1.5 - 1)).sum() / tot)

    def successor_avg_gap(self) -> float:
        return self._avg_from_bins(self.successor_gap_stats, log=False)

    def residual_avg_gap(self) -> float:
        return self._avg_from_bins(self.residual_gap_stats, log=False)

    def successor_avg_log_gap(self) -> float:
        return self._avg_from_bins(self.successor_gap_stats, log=True)

    def residual_avg_log_gap(self) -> float:
        return self._avg_from_bins(self.residual_gap_stats, log=True)


def _write_code(obs: OutputBitStream, coding: int, k: int, x: int) -> int:
    return obs.write(coding, x, k)


def _lower_bound_bits(n: int, m: int) -> float:
    """log2 C(n^2, m) via Stirling (reference stirling use at BVGraph.java:2652-2654)."""
    import math

    if m == 0 or n == 0:
        return 0.0

    def log_fact(x: float) -> float:
        if x < 1:
            return 0.0
        return x * math.log(x) - x + 0.5 * math.log(2 * math.pi * x)

    n2 = float(n) * float(n)
    return (log_fact(n2) - log_fact(m) - log_fact(n2 - m)) / math.log(2)


def _diff_comp(
    obs: OutputBitStream | None,
    s: BVGraphSettings,
    curr_node: int,
    ref: int,
    ref_list: list,
    curr_list: list,
    stats: _CompressionStats | None,
) -> int:
    """Differentially compress ``curr_list`` against ``ref_list``; if ``obs``
    is None only count bits. Faithful re-derivation of the reference merge
    (BVGraph.java diffComp:2049-2219): produce alternating copy/skip blocks
    over the reference list, intervalize the extras, gap-code the residuals.
    Returns the number of bits written (or that would be written).
    """
    for_real = obs is not None
    written = 0
    k = s.zeta_k

    ref_len = 0 if ref == 0 else len(ref_list)
    curr_len = len(curr_list)
    blocks: list[int] = []
    extras: list[int] = []

    j = 0  # index into curr_list
    t = 0  # index into ref_list
    copying = True
    curr_block_len = 0
    copied_here = 0
    while j < curr_len and t < ref_len:
        cj = curr_list[j]
        rt = ref_list[t]
        if copying:
            if cj > rt:
                blocks.append(curr_block_len)
                copying = False
                curr_block_len = 0
            elif cj < rt:
                extras.append(int(cj))
                j += 1
            else:
                j += 1
                t += 1
                curr_block_len += 1
                copied_here += 1
        else:
            if cj < rt:
                extras.append(int(cj))
                j += 1
            elif cj > rt:
                t += 1
                curr_block_len += 1
            else:
                blocks.append(curr_block_len)
                copying = True
                curr_block_len = 0
    if copying and t < ref_len:
        blocks.append(curr_block_len)
    while j < curr_len:
        extras.append(int(curr_list[j]))
        j += 1

    block_count = len(blocks)
    extra_count = len(extras)

    def emit(coding: int, x: int) -> int:
        if for_real:
            return obs.write(coding, x, k)
        return C.code_length(coding, x, k)

    if s.window_size > 0:
        b = emit(s.reference_coding, ref)
        written += b
        if for_real and stats:
            stats.bits_references += b
    if ref != 0:
        b = emit(s.block_count_coding, block_count)
        written += b
        if for_real and stats:
            stats.bits_blocks += b
        for i, blk in enumerate(blocks):
            b = emit(s.block_coding, blk if i == 0 else blk - 1)
            written += b
            if for_real and stats:
                stats.bits_blocks += b
        if for_real and stats:
            stats.copied_arcs += copied_here

    if extra_count > 0:
        if s.min_interval_length != NO_INTERVALS:
            left, lengths, residuals = _intervalize(extras, s.min_interval_length)
            b = emit(C.GAMMA, len(left))
            written += b
            if for_real and stats:
                stats.bits_intervals += b
            prev = 0
            for i, (l, ln) in enumerate(zip(left, lengths)):
                if i == 0:
                    b = emit(C.GAMMA, C.int2nat(l - curr_node))
                else:
                    b = emit(C.GAMMA, l - prev - 1)
                written += b
                if for_real and stats:
                    stats.bits_intervals += b
                prev = l + ln
                b = emit(C.GAMMA, ln - s.min_interval_length)
                written += b
                if for_real and stats:
                    stats.bits_intervals += b
                    stats.intervalised_arcs += ln
        else:
            residuals = extras
        if residuals:
            if for_real and stats:
                stats.residual_arcs += len(residuals)
                _CompressionStats.update_bins(curr_node, np.asarray(residuals), stats.residual_gap_stats)
            prev = residuals[0]
            b = emit(s.residual_coding, C.int2nat(prev - curr_node))
            written += b
            if for_real and stats:
                stats.bits_residuals += b
            for r in residuals[1:]:
                b = emit(s.residual_coding, r - prev - 1)
                written += b
                if for_real and stats:
                    stats.bits_residuals += b
                prev = r
    return written


def _intervalize(extras: list[int], min_interval: int):
    """Split an increasing list into >=min_interval runs + residuals
    (reference intervalize, BVGraph.java:1631-1654)."""
    left: list[int] = []
    lengths: list[int] = []
    residuals: list[int] = []
    vl = len(extras)
    i = 0
    while i < vl:
        j = 0
        if i < vl - 1 and extras[i] + 1 == extras[i + 1]:
            j = 1
            while i + j < vl - 1 and extras[i + j] + 1 == extras[i + j + 1]:
                j += 1
            j += 1
            if j >= min_interval:
                left.append(extras[i])
                lengths.append(j)
                i += j - 1
        if j < min_interval:
            residuals.append(extras[i])
        i += 1
    return left, lengths, residuals


def _compress_shard(
    it: NodeIterator,
    s: BVGraphSettings,
    graph_obs: OutputBitStream,
    offsets_obs: OutputBitStream,
    stats: _CompressionStats,
    final: bool,
    pl=None,
) -> None:
    """Compress one contiguous node range with a fresh reference window
    (reference CompressionThread.call, BVGraph.java:2222-2386)."""
    cbs = s.window_size + 1
    window: list[list[int]] = [[] for _ in range(cbs)]
    window_len = [0] * cbs
    ref_count = [0] * cbs

    while it.has_next():
        curr_node = it.next_int()
        outd = it.outdegree()
        curr_index = curr_node % cbs
        stats.node_count += 1
        if pl is not None:
            pl.update()

        _write_code(offsets_obs, s.offset_coding, s.zeta_k, graph_obs.written_bits - stats.last_offset)
        stats.last_offset = graph_obs.written_bits

        b = _write_code(graph_obs, s.outdegree_coding, s.zeta_k, outd)
        stats.bits_outdegrees += b

        curr_list = [int(v) for v in it.successor_array()[:outd]]
        window[curr_index] = curr_list
        window_len[curr_index] = outd

        if outd > 0:
            _CompressionStats.update_bins(curr_node, np.asarray(curr_list, dtype=np.int64), stats.successor_gap_stats)
            best_comp = None
            best_cand = -1
            best_ref = -1
            ref_count[curr_index] = -1
            for ref in range(cbs):
                cand = (curr_node - ref) % cbs
                if ref_count[cand] < s.max_ref_count and window_len[cand] != 0:
                    cost = _diff_comp(None, s, curr_node, ref, window[cand][: window_len[cand]], curr_list, None)
                    if best_comp is None or cost < best_comp:
                        best_comp = cost
                        best_cand = cand
                        best_ref = ref
            assert best_cand >= 0
            ref_count[curr_index] = ref_count[best_cand] + 1
            _diff_comp(graph_obs, s, curr_node, best_ref, window[best_cand][: window_len[best_cand]], curr_list, stats)
            stats.tot_links += outd
            stats.tot_ref += ref_count[curr_index]
            stats.tot_dist += best_ref
        else:
            ref_count[curr_index] = 0


# ----------------------------------------------------------------------
# Bulk decode on a torch device
# ----------------------------------------------------------------------


def prepare(g, device="cuda"):
    """Scan, route and move to ``device`` everything a decode needs.

    Returns a ``decode2.Prepared`` (K1) when K1 supports ``g``, else a
    ``decode.LevelPrepared`` (K2): both the depth plan of
    ``kernels/levels.py``, K1's with the records of at least
    ``decode2.LONG_ARCS`` arcs listed for a block each.  Raises
    NotImplementedError for graphs neither kernel decodes.  Host spans
    (``timing.span``): ``prepare``, holding ``prepare.scan``,
    ``prepare.plan`` and ``prepare.upload``."""
    if not K2.supports(g):
        s = g.settings
        raise NotImplementedError(
            f"no device kernel decodes this graph (codings "
            f"{s.flags_string()!r}, window {s.window_size}): K1 and K2 read "
            f"gamma, delta, zeta and unary codes with window <= 7.  Its host "
            f"path is webgraph_tpu_torch.formats.bvgraph_np.decode_to_csr; "
            f"an all-codings device decoder is ROADMAP A.11")
    with span("prepare"):
        with span("prepare.scan"):
            scan = scan_structure(g)
        if not D2.supports(g, scan):
            return K2.prepare(g, device, scan=scan)
        return D2.prepare(g, device, scan=scan)


def decode_prepared(prep) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a prepared graph: ``(offsets int64[n+1], successors
    int32[m])`` on the prepared device."""
    if isinstance(prep, K2.LevelPrepared):
        return K2.decode_prepared(prep)
    return D2.decode_prepared(prep)


def decode_to_csr(g, device="cuda"):
    """Decode ``g`` on ``device``: ``(offsets int64[n+1], successors
    int32[m])`` as tensors there, equal to ``bvgraph_np.decode_to_csr``.

    A CUDA device runs the K1 or K2 kernels; the CPU runs their plain
    PyTorch versions.  Raises NotImplementedError for graphs neither kernel
    decodes."""
    return decode_prepared(prepare(g, device))


def to_csr(g, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """``BVGraph.to_csr(backend="device")`` on a torch device: the decoded
    CSR as host numpy arrays."""
    off, succ = decode_to_csr(g, device)
    return off.cpu().numpy(), succ.cpu().numpy()
