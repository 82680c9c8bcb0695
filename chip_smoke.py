#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (webgraph_tpu_torch) on one GPU.

Drives the port's main path, bulk BVGraph decode into CSR, on the card,
through its two routes (K1 for reference chains that reach back at most
256 nodes, K2 for longer ones), batched random access through K1's
kernels, the analytics on the decoded graph, and the probe path (the
fragment probes on the TPU probe scripts' inputs), using only the port's
own modules:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the CUDA kernels from ``webgraph_tpu_torch/csrc``;
3. K0: the code-reader probe kernel against the plain PyTorch readers and
   the values written by the scalar encoder, exactly;
4. K1 small: ``k1_parse`` (run alone by ``kernels.decode2.parse_records``)
   against ``parse_records_plain`` in every slot it writes, the decode
   (``k1_parse`` then ``k2_resolve``) against ``resolve_copies_plain`` and
   against ``bvgraph_np.decode_to_csr``,
   exactly, on the graph set of tests/test_pallas_decode2.py and on
   ``synth.long_record_graph`` (records of 3,000-6,000 arcs) at the default
   ``long_arcs`` and at 2 (nearly every record a block);
5. K1 at size, ``weblike-cnr2000-size``: a seeded web-like graph of
   cnr-2000's size stored with cnr-2000's parameters, decoded through
   ``webgraph_tpu_torch.decode_to_csr(g, device="cuda")`` with the launch
   counters reset just before and read just after (``k1_parse`` and
   ``k2_resolve`` once each through K1's wrapper, K2's wrapper not), checked
   against the oracle and both plain versions, then timed (the decode, each
   kernel's device time from ``torch.profiler``, the plain versions, the
   decode at other ``long_arcs``, and K2's two kernels on the same graph as
   a yardstick);
   repeated on cnr-2000 itself where the fixture that ``bench.py`` reads
   exists;
6. K2's warp compaction: ``k2_compact_probe`` (the helper that
   ``k2_resolve`` compacts with) on the inputs of the JAX package's
   ``scripts/pallas_compact_chip.py``, exactly against NumPy, timed;
7. the fragment probes (``webgraph_tpu_torch/probes``, the counterparts of
   the JAX package's ``scripts/pallas_winmach_chip.py``,
   ``pallas_probe.py``, ``pallas_composite_probe.py``,
   ``pallas_fetch_bench.py`` and ``pallas_onehot_probe.py``): each
   module's ``run("cuda")`` on the script's inputs and on-chip sizes with
   the launch counts reset just before and read just after, then each of
   the eight probe kernels and K0's γ route exactly against its plain
   version (the composite ones at 2,048 trips), timed;
   then the in-loop primitive probes (``probes/timing5.py``,
   ``bisect4.py``, ``bisect3.py``, ``perf.py``, the counterparts of the JAX
   package's ``scripts/pallas_timing5.py``, ``pallas_bisect4.py``,
   ``pallas_bisect3.py`` and ``pallas_perf_probe.py``): each module's
   ``run("cuda")`` at the scripts' on-chip loop counts (a few cut) with the
   counts reset just before and read just after, then each run exactly
   against its plain version at 136 loops, timed, bounded, and beside a
   library call where one computes its primitive (``phase_loop_probes``);
   then the capability forms and the streaming decoder's probes
   (``probes/caps.py``, ``bisect.py``, ``bisect2.py``, ``v6.py``,
   ``v6b.py``, the counterparts of ``scripts/pallas_caps_probe.py``,
   ``pallas_bisect_probe.py``, ``pallas_bisect2.py``, ``v6_probe.py`` and
   ``v6_probe2.py``): each module's ``run("cuda")`` at the scripts' sizes
   and counts with the counts reset just before and read just after, each
   form against the script's own check and, exactly, its plain version,
   each loop run against its plain version at 136 loops or fewer, timed,
   bounded, and beside a library call where one computes the form
   (``phase_form_probes``);
8. K2 small: ``k2_parse`` against ``parse_records_plain`` (every slot it
   writes), the decode (``k2_parse`` then ``k2_resolve``) against the plain
   decoder and the oracle, exactly, on the graph set of
   tests/test_pallas_decode.py and config 3's deep-chain graph stored with
   unbounded maxref at minint 0, 4, 8;
9. K2 at size, ``weblike-cnr2000-size-maxref-inf``: the web-like graph with
   0.5% of its sites 300-3,000 pages long, stored with unbounded maxref,
   through the public entry point with the counters reset (``k2_parse`` and
   ``k2_resolve`` launched once each, K1 not), checked against the oracle
   and the plain versions of both kernels, then timed (each kernel's device
   time from ``torch.profiler``);
10. K2 stress, ``deep-chain-config3-minint2``: the same on config 3's graph
   at minint 2, whose chains run 17,819 deep;
11. batched random access (``kernels/query2.QueryPlanner``), after phases
   5 and 9 on their graphs: batches of 1, 16, 64, 1,024 and 16,384 nodes
   drawn by ``utils.rng.XoRoShiRo128PlusRandom(0)``, each
   ``successors_batch`` counted from 0 (``k1_parse`` and ``k2_resolve``
   once each through K1's wrapper, K2's wrapper not, over the batch's
   ancestor closure), exact against the bulk decode's CSR, then timed (host
   plan, each kernel, the batch, ns a node); the 1,024 batch's kernels
   held to their plain versions on the same closure;
12. the analytics on the K1 cell after its query phase
   (``phase_analytics``).

It prints a JSON line of per-kernel results and, last, a JSON line with the
device.  Any failure raises, so the exit code is not 0 and no last line is
printed.  Without a CUDA device it fails at once.

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the cnr-2000 fixture bench.py reads, where a machine has it
CNR2000 = "/root/reference/slow/it/unimi/dsi/webgraph/cnr-2000"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {card} | torch {torch.__version__} | cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return card


# the TPU kernel each probe kernel replaces (the kernel's definition)
PROBE_REPLACES = {
    "probe_winmach": "scripts/pallas_winmach_chip.py:47",
    "probe_relayout": "scripts/pallas_composite_probe.py:49",
    "probe_merge_trip": "scripts/pallas_composite_probe.py:70",
    "probe_refill": "scripts/pallas_composite_probe.py:117",
    "probe_compaction": "scripts/pallas_composite_probe.py:158",
    "probe_page_fetch": "scripts/pallas_composite_probe.py:213",
    "probe_fetch": "scripts/pallas_fetch_bench.py:31",
    "probe_row_gather": "scripts/pallas_onehot_probe.py:30"}
# the TPU functions (each reaches pallas_call) each in-loop kernel replaces
LOOP_REPLACES = {
    "probe_lane_loop": "scripts/pallas_timing5.py:56 trip_core; "
                       "scripts/pallas_bisect3.py:38 trip_variant, :82 trip_1x1024; "
                       "scripts/pallas_perf_probe.py:157 probe_rowstore, :207 probe_vpu",
    "probe_gather_loop": "scripts/pallas_timing5.py:99 gather_loop; "
                         "scripts/pallas_bisect3.py:110 gather_inloop_timed; "
                         "scripts/pallas_perf_probe.py:61 probe_replicated, "
                         ":128 probe_ownrow; scripts/pallas_bisect2.py:93 gather_in_loop",
    "probe_dot_loop": "scripts/pallas_timing5.py:125 matmul_loop; "
                      "scripts/pallas_bisect4.py:38 matmul_inloop",
    "probe_plane_refill": "scripts/pallas_bisect3.py:134 refill_variant; "
                          "scripts/pallas_perf_probe.py:89 probe_onehot",
    "probe_transpose_loop": "scripts/pallas_timing5.py:158 transpose_loop; "
                            "scripts/pallas_bisect4.py:69 transpose_inloop; "
                            "scripts/pallas_perf_probe.py:184 probe_transpose; "
                            "scripts/pallas_bisect2.py:72 transpose_in_loop",
    "probe_copy_loop": "scripts/pallas_timing5.py:178 dma_loop; "
                       "scripts/pallas_bisect4.py:87 dma_inloop",
    "probe_stack_fetch": "scripts/pallas_bisect3.py:193 stack_select_refill",
    "probe_jframe": "scripts/pallas_bisect3.py:232 j_part; "
                    "scripts/pallas_bisect4.py:110 j_frame"}
# the TPU functions each single-shot form kernel (forms.cu) and each v6 loop
# kernel (loops.cu) replaces; bisect2's two loops run on LOOP_REPLACES'
# probe_gather_loop and probe_transpose_loop (FORM_LOOP_KERNELS)
FORM_REPLACES = {
    "probe_form_gather": "scripts/pallas_caps_probe.py:60 probe_take_narrow, "
                         ":263 probe_take_wide; scripts/pallas_bisect_probe.py:44 "
                         "g_n128, :53 g_wide, :62 g_axis0; scripts/v6_probe.py:32 probe_ta0",
    "probe_form_relayout": "scripts/pallas_caps_probe.py:304 probe_transpose, "
                           ":339 probe_reshape; scripts/pallas_bisect_probe.py:105 tr, "
                           ":113 rshp, :121 bcast; scripts/v6_probe.py:49 probe_t8",
    "probe_form_roll": "scripts/pallas_caps_probe.py:77 probe_var_roll; "
                       "scripts/pallas_bisect2.py:84 dyn_roll",
    "probe_form_dot": "scripts/pallas_caps_probe.py:319 probe_dot_dim0; "
                      "scripts/pallas_bisect_probe.py:72 dot_var",
    "probe_form_onehot": "scripts/pallas_caps_probe.py:101 probe_onehot_scatter; "
                         "scripts/pallas_bisect_probe.py:86 dot_onehot_inkernel; "
                         "scripts/pallas_bisect2.py:34 onehotT_gather, :107 scatter_onehot",
    "probe_form_copy": "scripts/pallas_caps_probe.py:169 probe_dma, :210 probe_prefetch, "
                       ":280 probe_dma_flatten",
    "probe_form_scalar": "scripts/pallas_caps_probe.py:42 probe_clz, :142 probe_fori",
    "probe_v6_trip": "scripts/v6_probe.py:71 probe_trip",
    "probe_v6_fetch": "scripts/v6_probe.py:140 probe_fetch",
    "probe_body_loop": "scripts/v6_probe2.py:17 run_loop, bodies :72-155"}
KERNELS = {"decode2.cu": ("k1_parse", "k0_probe"),
           "decode.cu": ("k2_parse", "k2_resolve", "k2_compact_probe"),
           "propagate.cu": ("or_pull",),
           "probes.cu": tuple(PROBE_REPLACES),
           "loops.cu": tuple(LOOP_REPLACES)
           + ("probe_v6_trip", "probe_v6_fetch", "probe_body_loop"),
           "forms.cu": tuple(k for k in FORM_REPLACES if k.startswith("probe_form"))}
# the in-loop kernels the form probe path launches too (bisect2's loops)
FORM_LOOP_KERNELS = ("probe_gather_loop", "probe_transpose_loop")


def phase_build():
    """Builds the kernels; returns each kernel's registers."""
    from webgraph_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    libs = ", ".join(os.path.basename(_build.library_path(src))
                     for src in _build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.2f} s ({libs})")
    regs = {}
    for src, names in KERNELS.items():
        regs.update(_build.registers(src, names))
    check(set(regs) == {k for v in KERNELS.values() for k in v},
          f"ptxas reported registers of {sorted(regs)} only")
    print("registers (ptxas -v): "
          + ", ".join(f"{k} {v}" for k, v in regs.items()))
    return regs


def _code_stream(write):
    """Encode with the scalar writer; return (words, positions) on the card
    and the lengths."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.bits.bitstream import OutputBitStream, bytes_to_words

    obs = OutputBitStream()
    pos = []
    for item in write:
        pos.append(obs.written_bits)
        item(obs)
    ends = np.diff(np.asarray(pos + [obs.written_bits], dtype=np.int64))
    w = np.concatenate([bytes_to_words(obs.to_bytes()),
                        np.zeros(2, np.uint64)])
    words = torch.from_numpy(w.view(np.int64)).cuda()
    return words, torch.tensor(pos, dtype=torch.int64).cuda(), ends


def phase_k0():
    import numpy as np
    import torch

    from webgraph_tpu_torch.bits import codes as C
    from webgraph_tpu_torch.kernels import pcodes as P
    from webgraph_tpu_torch.timing import cuda_ms

    rng = np.random.default_rng(42)
    vals = np.concatenate([
        np.arange(64), rng.integers(0, 1 << 16, 200),
        rng.integers(0, 1 << 28, 100),
        np.array([2**31 - 1, 2**31], dtype=np.uint64)]).astype(np.uint64)
    cases = [("gamma", C.GAMMA, 0), ("delta", C.DELTA, 0)] + [
        (f"zeta{k}", C.ZETA, k) for k in range(1, 8)]
    err = 0
    for name, coding, k in cases:
        words, pos, lens = _code_stream(
            [lambda o, v=int(v): o.write(coding, v, k) for v in vals])
        got, ln = P.probe(words, pos, coding, k)
        pv, pl = P.probe_plain(words, pos, coding, k)
        check(np.array_equal(got.cpu().numpy(), vals.astype(np.int64)),
              f"K0 {name}: values differ from the written ones")
        check(np.array_equal(ln.cpu().numpy(), lens),
              f"K0 {name}: lengths differ from the written ones")
        check(torch.equal(got, pv) and torch.equal(ln.long(), pl),
              f"K0 {name}: kernel differs from the plain readers")
        err = max(err, int((got - pv).abs().max()))
    uv = rng.integers(0, 60, 100)
    words, pos, lens = _code_stream(
        [lambda o, v=int(v): o.write_unary(v) for v in uv])
    got, ln = P.probe(words, pos, C.UNARY)
    check(np.array_equal(got.cpu().numpy(), uv)
          and np.array_equal(ln.cpu().numpy(), lens), "K0 unary differs")
    bs = rng.integers(1, 1 << 20, 100)
    vs = (rng.random(100) * bs).astype(np.int64)
    words, pos, lens = _code_stream(
        [lambda o, v=int(v), b=int(b): o.write_minimal_binary(v, b)
         for v, b in zip(vs, bs)])
    bt = torch.from_numpy(bs.astype(np.int64)).cuda()
    got, ln = P.probe(words, pos, P.MINIMAL_BINARY, b=bt)
    pv, pl = P.probe_plain(words, pos, P.MINIMAL_BINARY, b=bt)
    check(np.array_equal(got.cpu().numpy(), vs)
          and np.array_equal(ln.cpu().numpy(), lens)
          and torch.equal(got, pv), "K0 minimal binary differs")

    # timing: 2**20 ζ_3 codes (the residual coding of the main path)
    big = rng.integers(0, 1 << 12, 1 << 20)
    words, pos, _ = _code_stream(
        [lambda o, v=int(v): o.write_zeta(v, 3) for v in big])
    ms = cuda_ms(lambda: P.probe(words, pos, C.ZETA, 3), 20)
    plain_ms = cuda_ms(lambda: P.probe_plain(words, pos, C.ZETA, 3), 5)
    got, _ = P.probe(words, pos, C.ZETA, 3)
    check(np.array_equal(got.cpu().numpy(), big), "K0 timing set differs")
    # bound: the stream and positions read once, values and lengths written
    nbytes = words.numel() * 8 + pos.numel() * (8 + 8 + 4)
    bound_ms, bound_by = _bound(nbytes, pos.numel())
    print(f"K0: {len(cases) + 2} codings exact vs plain readers and oracle; "
          f"2^20 zeta_3 codes: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _store(g, tmp, name, **kw):
    from webgraph_tpu_torch.formats.bvgraph import BVGraph

    base = os.path.join(tmp, name)
    BVGraph.store(g, base, **kw)
    return BVGraph.load(base)


def _cell(tmp, label):
    """A cell of ``synth.CELLS``, made and stored, loaded."""
    from webgraph_tpu_torch.synth import CELLS

    make, kw, _ = CELLS[label]
    return _store(make(), tmp, label, **kw)


def _csr_vs_oracle(bv, off, succ, what):
    import numpy as np

    from webgraph_tpu_torch.formats import bvgraph_np

    toff, tsucc = bvgraph_np.decode_to_csr(bv)
    check(np.array_equal(off.cpu().numpy(), toff), f"{what}: offsets differ")
    check(np.array_equal(succ.cpu().numpy(), tsucc),
          f"{what}: successors differ")


def phase_k1_small(tmp):
    from webgraph_tpu_torch.bits import codes as C
    from webgraph_tpu_torch.formats.bvgraph import BVGraphSettings
    from webgraph_tpu_torch.graph.builders import MutableGraph
    from webgraph_tpu_torch.graph.csr import CSRGraph
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.synth import CELLS, long_record_graph

    lists = []
    for x in range(120):
        if x % 17 == 0:
            lists.append([])
        elif x % 3 == 0:
            lists.append(list(range(x, x + 40)))
        elif x % 3 == 1:
            lists.append(list(range(x, x + 40)) + [200 + x, 400 + x])
        else:
            lists.append([1, 5, 9, 200 + 2 * x])
    delta = BVGraphSettings(window_size=4, max_ref_count=2,
                            min_interval_length=2)
    delta.codings["OUTDEGREES"] = C.DELTA
    delta.codings["BLOCKS"] = C.DELTA
    delta.codings["RESIDUALS"] = C.GAMMA
    er = MutableGraph.erdos_renyi
    cnr = CELLS["weblike-cnr2000-size"][1]
    graphs = [
        ("default", er(300, 0.03, seed=0),
         dict(window_size=7, max_ref_count=3, min_interval_length=4), None),
        *[(f"w{w}r{r}i{i}", er(n, p, seed=s),
           dict(window_size=w, max_ref_count=r, min_interval_length=i), None)
          for w, r, i, s, n, p in [(7, 3, 3, 1, 200, 0.08),
                                   (0, 0, 4, 2, 150, 0.05),
                                   (1, 1, 0, 3, 150, 0.05),
                                   (2, 2, 2, 4, 250, 0.04),
                                   (7, 7, 2, 5, 400, 0.02)]],
        ("structures", CSRGraph.from_lists(lists),
         dict(window_size=7, max_ref_count=3, min_interval_length=4), None),
        ("delta", er(200, 0.05, seed=9), dict(settings=delta), None),
        ("tiled", er(3000, m=30000, seed=11), {}, 2),
        ("long-records", long_record_graph(), cnr, None),
        ("long-records-long2", long_record_graph(), cnr, 2),
    ]
    for name, g, kw, long_arcs in graphs:
        bv = _store(g, tmp, name, **kw)
        prep = D2.prepare(bv, "cuda",
                          long_arcs=long_arcs or D2.LONG_ARCS)
        succ, *_ = _vs_plain(prep, D2.decode_records, D2.parse_records)
        _csr_vs_oracle(bv, prep.offsets, succ, f"K1 {name}")
        print(f"K1 small {name}: n {bv.num_nodes()} m {bv.num_arcs()} "
              f"levels {len(prep.bounds) - 1} long records "
              f"{prep.long.numel()} exact vs plain and oracle")
    print(f"K1 small: {len(graphs)} graphs exact vs plain versions and "
          f"oracle")


def _reset_counts():
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels import pcodes as P

    for c in (D2.decode_records.counts, K2.decode_levels.counts):
        for k in c:
            c[k] = 0
    D2.parse_records.launches = 0
    K2.parse_records.launches = 0
    K2.compact_probe.launches = 0
    P.probe.launches = 0


def _counts():
    """Launches since the last reset: each kernel by name under the route
    whose wrapper launched it (``k1``: ``decode2.decode_records``, ``k2``:
    ``decode.decode_levels``), and ``probes``: the probes and the parses
    alone (none on a main path)."""
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels import pcodes as P

    return {"k1": dict(D2.decode_records.counts),
            "k2": dict(K2.decode_levels.counts),
            "probes": P.probe.launches + K2.compact_probe.launches
            + K2.parse_records.launches + D2.parse_records.launches}


def _codes(bv, scan, nodes):
    """Codes a decode of the records of ``nodes`` must read once:
    outdegree, reference, block count and blocks, interval count and
    intervals, residuals."""
    import numpy as np

    s = bv.settings
    d = scan.d.astype(np.int64)[nodes]
    ref = scan.ref.astype(np.int64)[nodes]
    extra = np.where(ref > 0, d - scan.copied.astype(np.int64)[nodes], d)
    extra[d == 0] = 0
    return int((1 + ((d > 0) & (s.window_size > 0))
                + (ref > 0) * (1 + scan.block_count.astype(np.int64)[nodes])
                + ((extra > 0) & (s.min_interval_length != 0))
                * (1 + 2 * scan.int_count.astype(np.int64)[nodes])
                + scan.res_count.astype(np.int64)[nodes]).sum())


def _bound(nbytes, ops, int8_ops=0, bf16_ops=0):
    """Least time (ms, and what bounds it) for moving ``nbytes`` and doing
    ``ops`` 32-bit operations, ``int8_ops`` int8 and ``bf16_ops`` bf16
    tensor-core operations on one H100: 3.35 TB/s, 67 T 32-bit operations/s
    outside the tensor cores (the H100 SXM's published float32 rate, taken
    for the integer rate), 1,979 T int8 and 989 T bf16 operations/s
    (dense)."""
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = (ops / 67e12 + int8_ops / 1979e12 + bf16_ops / 989e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _events_ms(fn):
    """(result, milliseconds) of one run of ``fn``, by CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


# long_arcs of the sweep at size; one past the largest outdegree gives no
# record a block
LONG_SWEEP = (256, 1024, 4096, None)


def phase_main(bv, label, card, tmpdir):
    import numpy as np
    import torch

    import webgraph_tpu_torch as wgt
    from webgraph_tpu_torch.formats import bvgraph as F
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels.plan import scan_structure
    from webgraph_tpu_torch.synth import CELLS, weblike_graph
    from webgraph_tpu_torch.timing import cuda_ms, kernel_ms, kernel_runs

    n, m = bv.num_nodes(), bv.num_arcs()
    t0 = time.perf_counter()
    scan = scan_structure(bv)
    scan_s = time.perf_counter() - t0
    depth = int(scan.depth.max(initial=0))
    copied = float(scan.copied.astype(np.int64).sum()) / m
    res = int(scan.res_count.astype(np.int64).sum())
    iarcs = m - int(scan.copied.astype(np.int64)[scan.ref > 0].sum()) - res
    t0 = time.perf_counter()
    prep = F.prepare(bv, "cuda")
    plan_s = time.perf_counter() - t0
    check(isinstance(prep, D2.Prepared), f"{label}: not routed to K1")
    print(f"{label}: n {n} m {m} copied {copied:.4f} interval "
          f"{iarcs / m:.4f} max depth {depth} long records "
          f"{prep.long.numel()} (long_arcs {prep.long_arcs}, largest "
          f"{int(scan.d.max())} arcs); scan {scan_s:.2f} s, plan "
          f"(scan + levels + copy to the card) {plan_s:.2f} s")
    check(copied >= 0.2, f"{label}: copied share {copied:.3f} under 0.2")
    check(iarcs > 0, f"{label}: no interval arcs")

    # the main path, through the public entry point, counted
    _reset_counts()
    off, succ = wgt.decode_to_csr(bv, device="cuda")
    torch.cuda.synchronize()
    c = _counts()
    check(c["k1"] == {"k1_parse": 1, "k2_resolve": int(depth > 0)}
          and not any(c["k2"].values()) and c["probes"] == 0,
          f"{label}: launches {c}, max depth {depth}")
    _csr_vs_oracle(bv, off, succ, label)

    # timing, planning excluded: warm-up, then median of 5; each kernel's
    # device time and the device's busy share (from the start of k1_parse
    # to the end of k2_resolve) from 5 traced decodes
    F.decode_prepared(prep)
    decode_ms = cuda_ms(lambda: F.decode_prepared(prep), 5)
    names = ("k1_parse", "k2_resolve") if depth else ("k1_parse",)
    runs = kernel_runs(lambda: D2.decode_prepared(prep), 5, names)
    kms = {"k2_resolve": 0.0, **{k: float(np.median(
        [(r[k][1] - r[k][0]) / 1e3 for r in runs])) for k in names}}
    busy = float(np.median([
        sum(e - b for b, e in r.values())
        / (max(e for _, e in r.values()) - r["k1_parse"][0]) for r in runs]))
    ksucc, perr, cerr, parse_plain, copy_plain = _vs_plain(
        prep, D2.decode_records, D2.parse_records)
    check(torch.equal(ksucc, succ), f"{label}: K1 runs differ")
    (pb, pby), (cb, cby) = _prep_bounds(bv, prep, scan)
    print(f"{label}: launches k1_parse {c['k1']['k1_parse']} k2_resolve "
          f"{c['k1']['k2_resolve']}, K2's wrapper 0; decode "
          f"{decode_ms:.4f} ms = {m / decode_ms / 1e3:.2f} Medges/s; "
          f"k1_parse {kms['k1_parse']:.4f} ms (bound {pb:.4f} ms, {pby}), "
          f"k2_resolve {kms['k2_resolve']:.4f} ms (bound {cb:.4f} ms, "
          f"{cby}); plain {parse_plain:.1f} + {copy_plain:.1f} ms; busy "
          f"share {busy:.4f} ({len(runs)} whole traced decodes); card {card}")

    # k1_parse on the same generator without its hubs
    hubless = _store(weblike_graph(hubs=0), tmpdir, "weblike-hubs0",
                     **CELLS["weblike-cnr2000-size"][1])
    hp = D2.prepare(hubless, "cuda")
    parse_hubless = kernel_ms(lambda: D2.decode_prepared(hp), 5,
                              ("k1_parse",))["k1_parse"]
    print(f"{label}: nodes per depth {np.diff(prep.bounds).tolist()}; "
          f"k1_parse without the 12 hubs {parse_hubless:.4f} ms "
          f"({hp.long.numel()} long records)")

    # the decode with other long-record thresholds, exact
    sweep = {}
    for la in LONG_SWEEP:
        p2 = D2.prepare(bv, "cuda", scan=scan,
                        long_arcs=la or int(scan.d.max()) + 1)
        check(torch.equal(D2.decode_prepared(p2)[1], succ),
              f"{label}: long_arcs {la} differs")
        sweep[la] = (p2.long.numel(), cuda_ms(lambda: D2.decode_prepared(p2),
                                              5),
                     kernel_ms(lambda: D2.decode_prepared(p2), 5,
                               ("k1_parse",))["k1_parse"])
    print(f"{label}: long_arcs sweep (long records, decode ms, k1_parse "
          f"ms): " + "; ".join(f"{la or 'none'}: {v[0]}, {v[1]:.4f}, "
                               f"{v[2]:.4f}" for la, v in sweep.items()))

    # yardstick: K2's two kernels on the same graph (never on this path)
    k2p = K2.prepare(bv, "cuda", scan=scan)
    check(torch.equal(K2.decode_prepared(k2p)[1], succ),
          f"{label}: K2 differs")
    k2_ms = cuda_ms(lambda: K2.decode_prepared(k2p), 5)
    k2k = kernel_ms(lambda: K2.decode_prepared(k2p), 5,
                    ("k2_parse", "k2_resolve"))
    print(f"{label}: yardstick K2 decode {k2_ms:.4f} ms (k2_parse "
          f"{k2k['k2_parse']:.4f} ms, k2_resolve {k2k['k2_resolve']:.4f} "
          f"ms); card {card}")
    return {
        "k1_parse": {"launches": c["k1"]["k1_parse"], "max_abs_err": perr,
                     "ms": kms["k1_parse"], "plain_ms": parse_plain,
                     "bound_ms": pb, "bound_by": pby},
        "k2_resolve": {"launches": c["k1"]["k2_resolve"],
                       "max_abs_err": cerr, "ms": kms["k2_resolve"],
                       "plain_ms": copy_plain, "bound_ms": cb,
                       "bound_by": cby},
        "decode_ms": decode_ms,
        "csr": (off, succ),
        "scan": scan,
    }


def _k2_graphs():
    """The graph set of tests/test_pallas_decode.py and config 3's
    deep-chain graph stored with unbounded maxref: (name, graph, store
    keywords, meant for K2 only)."""
    from webgraph_tpu_torch.graph.builders import MutableGraph
    from webgraph_tpu_torch.graph.csr import CSRGraph
    from webgraph_tpu_torch.synth import MAXREF_INF, deep_chain_graph

    er = MutableGraph.erdos_renyi
    structures = [sorted(set(v for v in list(range(x + 1, x + 20))
                             + [200 + (x % 7), 300 + 2 * (x % 11)] if v < 400))
                  for x in range(120)] + [[]] * 280
    deep = [sorted(set(range(0, 1 + x % 37)) | {399 - (x % 5)})
            for x in range(200)] + [[]] * 200
    graphs = [
        (f"er_w{w}r{r}i{i}", er(n, p, seed=s),
         dict(window_size=w, max_ref_count=r, min_interval_length=i), False)
        for w, r, i, s, n, p in [(7, 3, 4, 0, 300, 0.03),
                                 (7, 3, 3, 1, 200, 0.08),
                                 (0, 0, 4, 2, 150, 0.05),
                                 (1, 1, 0, 3, 150, 0.05),
                                 (2, 2, 2, 4, 250, 0.04),
                                 (7, 7, 2, 5, 400, 0.02)]]
    graphs += [
        ("multiblock", er(400, 0.03, seed=11), {}, False),
        ("structures", CSRGraph.from_lists(structures), {}, False),
        ("deep_chains", CSRGraph.from_lists(deep),
         dict(window_size=7, max_ref_count=100, min_interval_length=2), False),
        ("empty_and_single", CSRGraph.from_lists([[], [0], [], [1, 2], []]),
         {}, False),
    ]
    g = deep_chain_graph()
    # minint 2 is held to the plain decoder by the stress phase
    graphs += [(f"deep-chain-config3-minint{i}", g,
                dict(window_size=7, max_ref_count=MAXREF_INF,
                     min_interval_length=i), True) for i in (0, 4, 8)]
    return graphs


def _vs_plain(prep, decode, parse):
    """A route's kernels against their plain versions on the same inputs:
    the parse alone (``parse``: ``k1_parse`` or ``k2_parse``) against
    ``parse_records_plain`` in every slot it writes, and the decode
    (``decode``) against ``resolve_copies_plain`` of that parse.  Returns
    (succ, parse max |err|, copy max |err|, plain parse ms, plain copy
    ms)."""
    from webgraph_tpu_torch.kernels import levels as L

    args, sizes = prep.args(), prep.sizes()
    succ = decode(*args, **sizes)
    parsed = parse(*args, **sizes)
    plain, parse_ms = _events_ms(
        lambda: L.parse_records_plain(*args[:7], **sizes))
    perr = 0
    for name, got, want in zip(plain._fields, parsed, plain):
        check(got.shape == want.shape, f"parse {name}: shape differs")
        if got.numel():
            perr = max(perr, int((got.long() - want.long()).abs().max()))
    check(perr == 0, f"parse differs from plain (max |err| {perr})")
    (psucc, err), copy_ms = _events_ms(lambda: L.resolve_copies_plain(
        plain, prep.order, prep.bounds, prep.offsets, prep.bstart,
        m=prep.m))
    L.check_errors(err, prep.order)
    cerr = int((succ.long() - psucc.long()).abs().max()) if succ.numel() else 0
    check(cerr == 0, f"copies differ from plain (max |err| {cerr})")
    return succ, perr, cerr, parse_ms, copy_ms


def phase_k2_probe():
    """k2_compact_probe on the inputs of scripts/pallas_compact_chip.py,
    exactly against NumPy and its plain version, then timed."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.timing import kernel_ms

    rng = np.random.default_rng(11)
    cnt = rng.integers(0, 17, 1024).astype(np.int32)
    pre = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    vals = rng.integers(1, 1 << 20, (128, 1024)).astype(np.int32)
    pool_size, depth = 160 * 128, 16
    exp = np.zeros(pool_size, np.int64)
    for lane in range(1024):
        exp[pre[lane]:pre[lane] + cnt[lane]] = vals[:cnt[lane], lane]
    acc = int(cnt.sum())
    qpos = rng.integers(0, max(acc - 16, 1), 1024).astype(np.int32)
    exp_q = np.stack([exp[qpos + k] for k in range(depth)])
    args = [torch.from_numpy(a).cuda() for a in (vals, cnt, qpos)]
    pool, q = K2.compact_probe(*args, pool_size, depth)
    check(np.array_equal(pool.cpu().numpy(), exp)
          and np.array_equal(q.cpu().numpy(), exp_q),
          "k2_compact_probe differs from NumPy")
    (ppool, pq), plain_ms = _events_ms(
        lambda: K2.compact_probe_plain(*args, pool_size, depth))
    err = max(int((pool - ppool).abs().max()), int((q - pq).abs().max()))
    check(err == 0, "k2_compact_probe differs from its plain version")
    ms = kernel_ms(lambda: K2.compact_probe(*args, pool_size, depth), 20,
                   ("k2_compact_probe",))["k2_compact_probe"]
    # the counts and fetch positions read, the values moved read and
    # written once, the fetched slots written
    nbytes = 2 * 1024 * 4 + 2 * acc * 4 + depth * 1024 * 4
    bound_ms, bound_by = _bound(nbytes, acc + depth * 1024)
    print(f"k2_compact_probe: 1,024 lanes, {acc} values, {depth} fetched a "
          f"lane, exact vs NumPy and plain; kernel {ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# composite trips at which phase_probes holds the kernels to their plain
# versions (a plain loop of 2**17 torch steps would take minutes)
PROBE_TRIPS = 2048
# integer operations a lane a trip (a rep) of each composite kernel, for its
# bound: G one add; H the trip's ~30 (csrc/probes.cu); I the page index,
# alignment, four byte loads and the word; J two a word of the lane's
# 128-word row (the byte-wise add, the carry); K one add a fetched word
PROBE_OPS = {"G": 1, "H": 30, "I": 12, "J": 2 * 128, "K": 128}


def _max_err(got, want):
    """Max |got - want| over two tuples of tensors of equal shapes."""
    err = 0
    for g, w in zip(got, want, strict=True):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            d = g.double() - w.double() if g.is_floating_point() else g.long() - w.long()
            err = max(err, d.abs().max().item())
    return err


def _probe_bytes(name, arrays):
    """Bytes a composite run must move: its inputs read once, its outputs
    written once (H: out, the queue's 8 rows, the 128-row slab; J: out and
    the pool; K: out and the checksum)."""
    tile = 4 * 1024
    ins = sum(a.nbytes for a in arrays)
    return ins + {"G": tile, "H": tile + 8 * tile + 128 * tile, "I": tile,
                  "J": tile + 512 * (int(name[1:]) if name[0] == "J" else 0),
                  "K": 2 * tile}[name[0]]


def phase_probes():
    """The fragment probes (``webgraph_tpu_torch/probes``, the counterparts
    of the JAX package's ``scripts/pallas_winmach_chip.py``,
    ``pallas_probe.py``, ``pallas_composite_probe.py``,
    ``pallas_fetch_bench.py`` and ``pallas_onehot_probe.py``) on the
    scripts' own inputs and on-chip sizes (composite ``TRIPS`` 2**17, fetch
    ``K`` 512, 1,024 lanes x 8 ζ₃ codes, 4,096 γ codes, 256 x 128
    gathers).  The probe path is each module's ``run("cuda")``, the entry
    point of ``python -m webgraph_tpu_torch.probes.<name>``, with every
    launch count reset just before and read just after; each checks its
    result (the written codes, ``T[idx]``, the plain fetch sum) and times
    its kernels by CUDA events (median of 5 after a warm-up).  Then each
    kernel is held to its plain version on the same inputs, exactly: at
    full size for B.1, B.2, B.4 and B.5, and for the composite kernels at
    :data:`PROBE_TRIPS` trips, since a plain loop of 2**17 trips of torch
    operations would take minutes (their ``plain_ms`` is at that size: each
    row gives ``reps``, the loop count of its ``ms``, and ``plain_reps``).
    Returns each kernel's row, and the γ route of ``k0_pcodes`` under
    ``"gamma"``."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.bits import codes as C
    from webgraph_tpu_torch.kernels import pcodes as P
    from webgraph_tpu_torch.probes import composite as CP
    from webgraph_tpu_torch.probes import fetch as FB
    from webgraph_tpu_torch.probes import gamma as GM
    from webgraph_tpu_torch.probes import onehot as OH
    from webgraph_tpu_torch.probes import winmach as WM
    from webgraph_tpu_torch.timing import cuda_ms, kernel_ms

    wrappers = {"probe_winmach": WM.winmach, "probe_relayout": CP.relayout,
                "probe_merge_trip": CP.merge_trip, "probe_refill": CP.refill,
                "probe_compaction": CP.compaction,
                "probe_page_fetch": CP.page_fetch, "probe_fetch": FB.fetch,
                "probe_row_gather": OH.row_gather}
    for w in wrappers.values():
        w.launches = 0
    P.probe.launches = 0
    wm, gm, cp, fb, oh = (WM.run("cuda"), GM.run("cuda"), CP.run("cuda"),
                          FB.run("cuda"), OH.run("cuda"))
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["gamma"] = P.probe.launches
    print("probe path launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(all(v >= 1 for v in launches.values()),
          f"a probe kernel was not launched on the probe path: {launches}")
    check(wm["ok"], f"probe_winmach: {wm['bad']} codes differ from the oracle")
    check(gm["ok"], "gamma route: values or positions differ")
    check(fb["ok"], f"probe_fetch differs from the plain sum: {fb['values']}")
    check(oh["ok"], "probe_row_gather differs from T[idx]")

    def held(name, kernel, fn, plain, nbytes, ops, ms):
        """``fn()`` (a wrapper call launching ``kernel`` once) against
        ``plain()``, exactly; the plain version timed on its second run,
        the kernel's own device time from a trace (``device_ms``; ``ms``
        is the wrapper's CUDA-event time, launch included): the numbers
        of a row."""
        as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
        err = _max_err(as_tuple(fn()), as_tuple(plain()))
        check(err == 0, f"{name} differs from its plain version "
                        f"(max |err| {err})")
        _, plain_ms = _events_ms(plain)
        device = kernel_ms(fn, 5, (kernel,))[kernel]
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"{name}: exact vs plain; wrapper {ms:.4f} ms, kernel "
              f"{device:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
              f"plain {plain_ms:.4f} ms")
        return {"max_abs_err": err, "ms": ms, "device_ms": device,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    none = "none: no single PyTorch call computes it"
    rows = {}
    # B.1: the stream, the starts and the codes moved once, a read a code
    vals, words, starts = WM.inputs()
    w = torch.from_numpy(WM.stream_words(words)).cuda()
    st = torch.from_numpy(starts).cuda()
    rows["probe_winmach"] = {**held(
        "probe_winmach", "probe_winmach", lambda: WM.winmach(w, st),
        lambda: WM.winmach_plain(w, st),
        w.numel() * 8 + st.numel() * 8 + vals.size * 4, vals.size, wm["ms"]),
        "library_ms": None, "library_note": none}
    # B.2: k0_probe's γ route; the stream, positions, values, lengths once
    _, data, pos, _ = GM.inputs()
    w = torch.from_numpy(GM.stream_words(data)).cuda()
    p = torch.from_numpy(pos).long().cuda()
    rows["gamma"] = {**held(
        "k0_probe (gamma route)", "k0_probe", lambda: P.probe(w, p, C.GAMMA),
        lambda: P.probe_plain(w, p, C.GAMMA),
        w.numel() * 8 + p.numel() * (8 + 8 + 4), p.numel(), gm["ms"]),
        "library_ms": None, "library_note": none}
    # B.3: each run against its plain loop at PROBE_TRIPS, timed and bounded
    # at the script's trips; a kernel's row sums its runs
    ins = CP.inputs()
    for name, r in cp.items():
        args = [torch.from_numpy(a).cuda() for a in ins[name]]
        kernel = CP.KERNELS[name[0]]
        plain = getattr(CP, kernel.__name__ + "_plain")
        extra = (int(name[1:]),) if name[0] == "J" else ()
        nr = CP.reps(name, PROBE_TRIPS)
        one = held(f"probe_{kernel.__name__} {name}",
                   f"probe_{kernel.__name__}",
                   lambda: CP.call(name, args, PROBE_TRIPS),
                   lambda: plain(*args, *extra, nr),
                   _probe_bytes(name, ins[name]),
                   r["reps"] * 1024 * PROBE_OPS[name[0]], r["ms"])
        # device_ms was traced at PROBE_TRIPS: the kernel's time at the
        # comparison size, beside the plain version's
        one.update(reps=r["reps"], plain_reps=nr,
                   device_ms_at_plain_reps=one.pop("device_ms"),
                   per_rep=CP.cost(name, r["ms"], r["reps"]).strip())
        agg = rows.setdefault(f"probe_{kernel.__name__}", {
            "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": one["bound_by"], "reps": r["reps"], "plain_reps": nr,
            "library_ms": None, "library_note": none, "runs": {}})
        agg["runs"][name] = one
        agg["max_abs_err"] = max(agg["max_abs_err"], one["max_abs_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            agg[k] += one[k]
        if name == "G":  # out = x + reps, which one torch.add computes
            x, n = args[0], r["reps"]
            check(torch.equal(torch.add(x, n), r["out"][0]),
                  "torch.add(x, TRIPS) differs from probe_relayout")
            agg.update(library_ms=cuda_ms(lambda: torch.add(x, n), 5),
                       library_note="torch.add(x, TRIPS)")
    # B.4: K steps x 1,024 lanes x 16 words summed; pos and pool read once
    pos, pool = FB.inputs()
    p, q = torch.from_numpy(pos).cuda(), torch.from_numpy(pool).cuda()
    rows["probe_fetch"] = {**held(
        "probe_fetch", "probe_fetch", lambda: FB.fetch(p, q),
        lambda: FB.fetch_plain(p, q),
        pos.nbytes + pool.nbytes + 4, 2 * pos.size * FB.K * 16,
        statistics.median(fb["ms"].values())),
        "modes_ms": fb["ms"], "library_ms": None,
        "library_note": "none: no single PyTorch call gathers and sums"}
    # B.5: the byte planes, the indices and the output moved once
    words, planes, idx = OH.inputs()
    pl, ix = torch.from_numpy(planes).cuda(), torch.from_numpy(idx).cuda()
    table = torch.from_numpy(words.view(np.int32)).cuda()
    flat = ix.long()  # torch.take's indices are int64
    check(torch.equal(torch.take(table, flat), oh["out"]),
          "torch.take differs from probe_row_gather on the script's inputs")
    torch.take(table, flat)
    rows["probe_row_gather"] = {**held(
        "probe_row_gather", "probe_row_gather", lambda: OH.row_gather(pl, ix),
        lambda: OH.row_gather_plain(pl, ix),
        planes.nbytes + 2 * idx.nbytes, idx.size, oh["ms"]),
        "library_ms": cuda_ms(lambda: torch.take(table, flat), 5),
        "library_note": "torch.take(T, idx): equal to the kernel on the "
                        "script's inputs only, where each row's indices "
                        "share one table row"}
    for name, r in rows.items():
        r["launches"] = launches[name]
    for name, r in cp.items():
        print(f"{name:5s} {CP.KERNELS[name[0]].__name__:11s}: "
              f"{CP.cost(name, r['ms'], r['reps'])} ({r['reps']} reps)")
    return rows


# loop counts phase_loop_probes cuts from the script's (in the comment), so
# that the phase stays near a minute: 6 timed runs of each at these counts
LOOP_CUTS = {"timing5": {"G1024": 1 << 16,   # 2**19
                         "M1": 1 << 13},     # 2**15
             "bisect3": {"G1024": 1 << 15}}  # 2**17
# loops at which each in-loop probe is held to its plain version (past 128,
# so the slab row store wraps onto row 0, and past the copy's 32 slices)
LOOP_PLAIN_REPS = 136


def _loop_work(probe, reps):
    """(bytes, 32-bit integer operations, int8 tensor-core operations) a run
    of ``probe`` at ``reps`` loops must move and do: its inputs read once
    and its outputs written once; a lane's (or a word's) operations a loop
    as counted in each branch."""
    from webgraph_tpu_torch.probes import loops as L

    ins = sum(a.nbytes for a in probe.arrays)
    tile, k, pr = 4096, probe.kernel, probe.params
    if k is L.lane_loop:  # out, the queue's 8 rows, the slab
        f = pr["flags"]
        per = ((6 if f & L.LL_VPU else 7) * pr["rounds"]
               + 2 * bool(f & L.LL_ROWSTORE) + bool(f & L.LL_RESHAPE)
               + 9 * bool(f & (L.LL_QUEUE_HALF | L.LL_QUEUE_ODD))
               + bool(f & (L.LL_STORE_V | L.LL_STORE_T)))
        return ins + tile * (9 + pr.get("slab", L.SLAB)), reps * 1024 * per, 0
    if k is L.gather_loop:  # the index (an add and a modulo), the carry's add and mask
        rows, cols = probe.arrays[0].shape
        index = 2 * (128 if pr["mode"] in (L.GL_ROWS, L.GL_COL) else rows * cols)
        return ins + 2 * tile, reps * (index + 2 * 1024), 0
    if k is L.dot_loop:
        a, b = probe.arrays
        if pr["onehot"]:  # an add a word of the lane's row; a is not read
            return b.nbytes + 2 * tile, reps * 1024 * b.shape[1], 0
        m, kk, n = a.shape[0], a.shape[1], b.shape[1]  # xor and add a sum
        return ins + tile + 4, reps * m * n * 2, 2 * reps * m * kk * n
    if k is L.plane_refill:  # 4 bytes shifted in and added a word
        words = 8 if pr["mode"] == L.PR_REFILL else 128
        return ins + 2 * tile, reps * 1024 * words * (8 if words == 8 else 2), 0
    if k is L.transpose_loop:  # the carry's adds (and mask); TL_ADDC an add a word
        per = {L.TL_MASK: 3, L.TL_ADDC: 1, L.TL_NOMASK: 2}[pr["addc"]] * 1024
        words = probe.arrays[0].size if pr["addc"] == L.TL_ADDC else 0
        return ins + 2 * tile, reps * (per + words), 0
    if k is L.copy_loop:  # the slices copied, an add a word
        return min(reps, 32) * 32768 + 2 * tile, reps * 8192, 0
    if k is L.stack_fetch:  # 8 adds and ~6 for the index
        return ins + 2 * tile, reps * 1024 * 14, 0
    slab = pr["stage"] not in ("v0", "v1", "v4")  # jframe: a lane's 128-word row
    per = 1 + 128 * slab + 128 * (pr["stage"] == "p3")
    return ins + 2 * tile + L.JR * 512, reps * 1024 * per, 0


def _loop_library(probe, args):
    """(ms, note) of one PyTorch call that computes one loop's primitive of
    ``probe`` (median of 5 by CUDA events), checked first against the
    kernel's first loop; (None, note) where no single call does."""
    import torch

    from webgraph_tpu_torch.probes import loops as L
    from webgraph_tpu_torch.timing import cuda_ms

    k, pr = probe.kernel, probe.params
    first = probe.call(args, 1)
    out1 = first[0].long()
    if k is L.gather_loop:
        tbl, c0 = args[0], args[1].long()
        rows, cols = tbl.shape
        base = torch.arange(cols, device=tbl.device)[None, :].expand(rows, cols)
        if pr["mode"] in (L.GL_ROWS, L.GL_COL):
            key = c0[:1, :128] + (base if pr["mode"] == L.GL_ROWS else 0)
            idx, mask = (key & 127).expand(rows, cols), 0xFFFF
            part = (lambda v: v[:8, :128])
        elif pr["mode"] == L.GL_REPL:
            idx, mask = torch.remainder(base + c0[:, :1], cols), 0x7FFFFFFF
            part = (lambda v: v[:, :128])
        else:
            idx = torch.remainder(base + c0.reshape(1024, 1), cols)
            mask, part = 0x7FFFFFFF, (lambda v: v[:, :1].reshape(8, 128))
        lib = (lambda: torch.gather(tbl, 1, idx))
        check(torch.equal(out1, (c0 + part(lib()).long()) & mask),
              f"torch.gather differs from {probe.name}'s first trip")
        return cuda_ms(lib, 5), "torch.gather(table, 1, idx): one trip's take-along"
    if k is L.transpose_loop:
        x = args[0]
        lib = (lambda: x.t().contiguous())
        tr = lib()[:8, :128].long()
        check(torch.equal(out1, tr & 0x7FFF if pr["addc"] == L.TL_MASK else tr),
              f"x.t().contiguous() differs from {probe.name}'s first rep")
        return cuda_ms(lib, 5), "x.t().contiguous(): one rep's transpose"
    if k is L.copy_loop:
        x = args[0]
        buf = torch.empty((8, 1024), dtype=x.dtype, device=x.device)
        lib = (lambda: buf.copy_(x[0:8]))
        check(torch.equal(out1, x[0:8, :128].long() & 0x7FFF),
              f"the slice differs from {probe.name}'s first copy")
        return cuda_ms(lib, 5), "Tensor.copy_ of one rep's (8, 1024) slice"
    if k is L.dot_loop and not pr["onehot"]:
        a, b = args
        lib = (lambda: torch._int_mm(a, b))
        prod = lib().long()
        check(torch.equal(prod, (a.double() @ b.double()).long()),
              "torch._int_mm differs from the plain product")
        chk1 = (int(prod.sum()) + (1 << 31)) % (1 << 32) - (1 << 31)  # t = 0
        check(torch.equal(out1, (1 + prod[:8, :128]) & 0x7FFF)
              and int(first[1][0]) == chk1,
              f"torch._int_mm differs from {probe.name}'s product")
        return cuda_ms(lib, 5), "torch._int_mm(a, b): one rep's product"
    if k is L.dot_loop or (k is L.plane_refill and pr["mode"] == L.PR_ROWS):
        # a row gather: one-hot p = b[carry % k] from ones, or perf B's
        # p = table[carry] (the carry stays inside the table)
        tbl = args[1] if k is L.dot_loop else args[0]
        if k is L.dot_loop:
            idx = torch.full((1024,), 1 % tbl.shape[0], dtype=torch.long,
                             device=tbl.device)
        else:
            idx = args[1].long().reshape(1024)
        lib = (lambda: torch.index_select(tbl, 0, idx))
        p = lib().long()
        if k is L.dot_loop:
            ok = (torch.equal(out1, (1 + p[:8, :128]) & 0x7FFF)
                  and torch.equal(first[1].long(), p.sum(1)))
        else:
            ok = torch.equal(out1, torch.remainder(
                idx.reshape(8, 128) + p[:, 0].reshape(8, 128), tbl.shape[0]))
        check(ok, f"torch.index_select differs from {probe.name}'s first loop")
        return cuda_ms(lib, 5), "torch.index_select(table, 0, idx): one loop's row gather"
    return None, "none: no single PyTorch call computes it"


def phase_loop_probes():
    """The in-loop primitive probes (``webgraph_tpu_torch/probes``:
    ``timing5``, ``bisect4``, ``bisect3``, ``perf``, the counterparts of
    the JAX package's ``scripts/pallas_timing5.py``, ``pallas_bisect4.py``,
    ``pallas_bisect3.py`` and ``pallas_perf_probe.py``; the eight kernels of
    ``csrc/loops.cu``) on the scripts' inputs at the scripts' on-chip loop
    counts, but those :data:`LOOP_CUTS` cuts.  The probe path is each
    module's ``run("cuda")`` (the entry point of ``python -m
    webgraph_tpu_torch.probes.<name>``) with every launch count reset just
    before and read just after; it times each run by CUDA events (median of
    5 after a warm-up).  Then each run is held to its plain version exactly
    at :data:`LOOP_PLAIN_REPS` loops (a plain loop at the scripts' counts
    would take minutes), its kernel's own device time traced at that count
    (None where every trace dropped the kernel's records), its bound computed (:func:`_loop_work`) and, where one PyTorch call
    computes a loop's primitive, that call timed (:func:`_loop_library`).
    Returns each kernel's row, its runs under ``"runs"``."""
    import torch

    from webgraph_tpu_torch.probes import bisect3, bisect4, perf, timing5
    from webgraph_tpu_torch.probes import loops as L
    from webgraph_tpu_torch.timing import NoWholeRun, kernel_ms

    modules = {"timing5": timing5, "bisect4": bisect4, "bisect3": bisect3,
               "perf": perf}
    for w in L.KERNELS.values():
        w.launches = 0
    res = {m: M.run("cuda", cut=LOOP_CUTS.get(m)) for m, M in modules.items()}
    launches = {k: w.launches for k, w in L.KERNELS.items()}
    print("in-loop probe path launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(all(v >= 1 for v in launches.values()),
          f"an in-loop probe kernel was not launched on the probe path: {launches}")
    # a kernel's row sums its runs: ms and bound_ms over ``reps`` loops (the
    # probe path's), plain_ms and device_ms_at_plain_reps over ``plain_reps``
    rows = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "device_ms_at_plain_reps": 0.0, "reps": 0, "plain_reps": 0,
                "launches": launches[k],
                "library_ms": None, "library_note": None, "runs": {}}
            for k in L.KERNELS}
    for m, M in modules.items():
        for p in M.probes():
            r = res[m][p.name]
            args = [torch.from_numpy(a).cuda() for a in p.arrays]
            n = min(r["reps"], LOOP_PLAIN_REPS)
            err = _max_err(p.call(args, n), p.call(args, n, plain=True))
            check(err == 0, f"{m} {p.name}: {r['kernel']} differs from its plain "
                            f"version (max |err| {err})")
            _, plain_ms = _events_ms(lambda: p.call(args, n, plain=True))
            torch.cuda.synchronize()  # a fault of the runs above raises here
            try:  # a measurement only: the trace may drop a kernel's records
                device = kernel_ms(lambda: p.call(args, n), 5,
                                   (r["kernel"],))[r["kernel"]]
            except NoWholeRun as exc:
                device = None
                print(f"{m}/{p.name}: device time not measured ({exc})")
            bound_ms, bound_by = _bound(*_loop_work(p, r["reps"]))
            lib_ms, note = _loop_library(p, args)
            per_rep = L.cost(r).strip()
            print(f"{m}/{p.name}: {r['kernel']} exact vs plain at {n}; {r['reps']} "
                  f"reps {r['ms']:.4f} ms ({per_rep}), bound {bound_ms:.6f} ms "
                  f"({bound_by}), plain {plain_ms:.4f} ms at {n}"
                  + ("" if lib_ms is None else f"; library {lib_ms:.4f} ms a call"))
            agg = rows[r["kernel"]]
            agg["runs"][f"{m}/{p.name}"] = {
                "reps": r["reps"], "script_reps": p.reps, "plain_reps": n,
                "ms": r["ms"], "per_rep": per_rep, "device_ms_at_plain_reps": device,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
            for key, v in (("ms", r["ms"]), ("plain_ms", plain_ms),
                           ("bound_ms", bound_ms), ("device_ms_at_plain_reps", device)):
                agg[key] = None if v is None or agg[key] is None else agg[key] + v
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["reps"] += r["reps"]
            agg["plain_reps"] += n
            if agg["library_ms"] is None and lib_ms is not None:
                agg["library_ms"] = lib_ms
                agg["library_note"] = f"{m}/{p.name}: {note}"
    for agg in rows.values():
        worst = max(agg["runs"].values(), key=lambda x: x["bound_ms"])
        agg["bound_by"] = worst["bound_by"]
        agg["library_note"] = agg["library_note"] or "none: no single PyTorch call computes it"
    return rows



def _exact(got, want):
    """Max |got - want| (0: equal), raising where the dtypes or shapes
    differ."""
    for g, w in zip(got, want, strict=True):
        check(g.dtype == w.dtype, f"dtype {g.dtype} != {w.dtype}")
    return _max_err(got, want)


def _loop_of(form):
    """A form that runs on an in-loop kernel (bisect2's loops) as the
    :class:`loops.Probe` of its one run, its carry among the inputs."""
    from webgraph_tpu_torch.probes import loops as L

    params = {k: v for k, v in form.params.items() if k != "reps"}
    return L.Probe(form.name, form.kernel, form.arrays + form.consts, params,
                   form.params["reps"], "trip")


def _form_work(form, args, out):
    """(bytes, 32-bit operations, int8 and bf16 tensor operations) a form
    must move and do: each input word it needs read once (a gather reads
    the table words its indices reach, a copy the rows it copies), each
    output word it writes written once (a copy's other rows are filled
    outside the kernel); the operations an output word (a product's
    multiply-adds, a scatter's planes a source word).  The port's
    checksums are not counted."""
    import torch

    from webgraph_tpu_torch.probes import forms as F
    from webgraph_tpu_torch.probes import loops as L

    k, pr = form.kernel, form.params
    if k in (L.gather_loop, L.transpose_loop):
        return (*_loop_work(_loop_of(form), pr["reps"]), 0)
    pos = args if form.order is None else [args[i] for i in form.order]
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(out))
    words = out[0].numel()
    if k is F.dot:
        a, b = pos
        macs = 2 * b.numel() * (a.shape[1] if pr.get("trans_a") else a.shape[0])
        return (nbytes, macs if b.dtype == torch.float32 else 0,
                macs if b.dtype == torch.int8 else 0, macs if b.dtype == torch.bfloat16 else 0)
    if k is F.copy:
        src, offs = pos[0], (pos[1] if len(pos) > 1 else None)
        made = len(F.copies(src.shape[0], offs, pr["mode"]))
        moved = 2 * made * F.CP_ROWS[pr["mode"]] * F.ROW * 4  # in, then out
        return (0 if offs is None else offs.numel() * 4) + moved, moved // 8, 0, 0
    if k is F.gather:  # the distinct table words the indices reach
        tbl, idx = pos
        axis, span = pr.get("axis", 1), tbl.shape[pr.get("axis", 1)]
        ix = idx.long()
        ix = torch.where(ix < 0, ix + span, ix)
        ok = (ix >= 0) & (ix < span)
        other = torch.arange(idx.shape[1 - axis], device=ix.device)
        other = other[:, None] if axis == 1 else other[None, :]
        flat = ix * tbl.shape[1] + other if axis == 0 else other * tbl.shape[1] + ix
        reached = torch.unique(flat[ok]).numel()
        return nbytes - tbl.numel() * 4 + reached * 4, words, 0, 0
    if k is F.onehot:
        ops = {F.OH_SCATTER: pos[0].numel() * 8 + words * 8, F.OH_GATHER_I8: words,
               F.OH_SCATTER_SUM: pos[0].numel() + words}.get(pr["mode"], words * 12)
        if pr["mode"] in (F.OH_GATHER_I8, F.OH_GATHER_PLANES, F.OH_GATHER_BF16):
            pool, ix = pos[0], pos[1].long().reshape(-1)  # the pool rows reached
            rows = torch.unique(ix[(ix >= 0) & (ix < pool.shape[0])]).numel()
            row_bytes = pool.shape[1] * pool.element_size()
            nbytes += (rows - pool.shape[0]) * row_bytes
        return nbytes, ops, 0, 0
    per = {F.roll: 2, F.scalar: max(pr.get("trips", 0), 1)}.get(k, 1)
    return nbytes, words * per, 0, 0


def _v6_work(probe, reps):
    """(bytes, 32-bit operations, 0) a v6 loop run must move and do: each
    input word it needs read once (the stream's words a body's windows
    reach, at most the stream), its outputs written once; the operations a
    lane a loop (counted from the TPU body's steps, the port's checksum
    adds left out)."""
    from webgraph_tpu_torch.probes import loops as L

    k, tile = probe.kernel, 4096
    if k is L.v6_trip:  # 8 sub-steps of ~30 operations
        return sum(a.nbytes for a in probe.arrays) + 4 + 6 * tile, reps * 1024 * 8 * 30, 0
    if k is L.v6_fetch:  # the planes' selected rows, idx, the gathered slab words
        r0 = probe.arrays[1]
        rows = sum(len(set(r0[g].tolist())) for g in range(r0.shape[0]))
        need = rows * 128 * 2 + r0.nbytes + probe.arrays[3].nbytes * 2 + 4
        return need + 4 * (reps + 1), reps * (128 * 128 * 8 + 1024 * 128 * 2), 0
    x = probe.arrays[0]
    body = probe.params["body"]
    reach = {"A": 1024 * 32, "B": 1024 * 128 * reps, "C": 1024 * 128 * reps,
             "D": 32 * 1024 * reps, "D2": 32 * 1024 * reps, "E": 1024 * 9,
             "F": 8 * (128 + 31)}[body]
    # A: the 32 adds of + i and the carry's add
    per = {"A": 33, "B": 384, "C": 384, "D": 96, "D2": 96, "E": 40, "F": 5}[body]
    return min(reach, x.size) * 4 + 4 + 2 * tile, reps * 1024 * per, 0


def _body_library(probe, args):
    """(ms, note) of one PyTorch call that computes one rep of a
    ``probe_body_loop`` body (median of 5 by CUDA events), checked first
    against the kernel's first rep; (None, note) where no single call
    does."""
    import torch

    from webgraph_tpu_torch.probes import loops as L
    from webgraph_tpu_torch.timing import cuda_ms

    x, body = args[0], probe.params["body"]
    i = int(args[1][0, 0])  # rep 0's i; the carry is 0
    out1 = probe.call(args, 1)[0].long().reshape(1024)
    if body == "A":
        buf = torch.empty((32, 1024), dtype=x.dtype, device=x.device)
        lib = (lambda: torch.add(x[:, :32].t(), i, out=buf))
        note = "torch.add(x[:, :32].t(), i, out=): one rep's transpose"
        got = lib()[0].long()
    elif body in ("B", "C"):
        base = i % (L.LW - 128)  # the clip never reaches: base + 127 < LW
        lib = (lambda: x.narrow(1, base, 128).clone())
        note = "x.narrow(1, base, 128).clone(): one rep's window"
        w = lib().long()
        got = w[:, 0] + (w[:, 31] if body == "B" else 0)
    elif body == "D":
        base = i % (L.LW - 64)
        lib = (lambda: x.narrow(0, base, 32).clone())
        note = "x.narrow(0, base, 32).clone(): one rep's 32 rows"
        g = lib().long()
        got = g[0] + g[31]
    elif body == "D2":  # rep 0's per-lane bases (the carry is 0)
        base = torch.full((1, 1024), i % (L.LW - 64), dtype=torch.long, device=x.device)
        idx = torch.clamp(torch.arange(32, device=x.device)[:, None] + base, 0, L.LW - 1)
        lib = (lambda: torch.gather(x, 0, idx))
        note = "torch.gather(x, 0, idx): one rep's 32 rows a lane"
        g = lib().long()
        got = g[0] + g[31]
    else:
        return None, "none: no single PyTorch call computes it"
    check(torch.equal(out1, got), f"{note} differs from {probe.name}'s first rep")
    return cuda_ms(lib, 5), note


def _form_library(form, args, out):
    """(ms, note) of one PyTorch call that computes ``form`` (or, for a
    loop, one trip of it), checked against the kernel's output first;
    (None, note) where no single call does."""
    import torch

    from webgraph_tpu_torch.probes import forms as F
    from webgraph_tpu_torch.probes import loops as L
    from webgraph_tpu_torch.timing import cuda_ms

    k, pr = form.kernel, form.params
    if k in (L.gather_loop, L.transpose_loop):
        return _loop_library(_loop_of(form), args)
    pos = args if form.order is None else [args[i] for i in form.order]
    lib, note, want = None, None, out[0]
    if k is F.gather:
        tbl, idx = pos
        ix = idx.long()
        lib, note = (lambda: torch.gather(tbl, pr.get("axis", 1), ix)), "torch.gather"
    elif k is F.relayout:
        x = pos[0]
        if pr["mode"] == F.RL_COPY:
            shape = pr["shape"]
            if x.numel() == torch.Size(shape).numel():
                lib, note = (lambda: x.reshape(shape).clone()), "reshape(...).clone()"
            else:
                lib, note = (lambda: x.expand(shape).contiguous()), "expand(...).contiguous()"
        elif pr.get("col") or pr.get("width", x.shape[0]) != x.shape[0]:
            pad = (pr["col"], pr["width"] - pr["col"] - x.shape[0])
            lib, note = (lambda: torch.nn.functional.pad(x.t(), pad)), "F.pad(x.t(), ...)"
        else:
            lib, note = (lambda: x.t().contiguous()), "x.t().contiguous()"
    elif k is F.roll and pr["mode"] == F.RO_AXIS0:
        x, sh = pos[0], int(pos[1][0])
        lib, note = (lambda: torch.roll(x, sh, 0)), "torch.roll"
    elif k is F.dot:
        a, b = pos
        ta = a.t() if pr.get("trans_a") else a
        if b.dtype == torch.int8:
            lib, note = (lambda: torch._int_mm(ta, b)), "torch._int_mm"
        elif b.dtype == torch.float32:
            lib, note = (lambda: torch.matmul(ta, b)), "torch.matmul"
        else:
            lib, note = (lambda: torch.mm(ta, b, out_dtype=torch.float32)), \
                "torch.mm(out_dtype=float32)"
        try:
            lib()
        except (RuntimeError, TypeError) as exc:  # shape rules, or no out_dtype
            return None, f"none: {note} refuses these operands ({type(exc).__name__})"
    elif k is F.onehot and pr["mode"] in (F.OH_GATHER_I8, F.OH_GATHER_PLANES, F.OH_GATHER_BF16):
        pool, idx = pos[0], pos[1].reshape(-1).long()
        lib, note = (lambda: torch.index_select(pool, 0, idx)), "torch.index_select"
    elif k is F.onehot:
        src, idx = pos[0], pos[1].reshape(-1).long()
        if pr["mode"] == F.OH_SCATTER:
            base = torch.zeros((pr["rows"], 128), dtype=torch.int32, device=src.device)
            lib = (lambda: base.clone().index_add_(0, idx, src))
            note = "index_add_ of the int32 rows (equal on the script's inputs only)"
        else:
            vals = src.reshape(-1).to(torch.bfloat16).float()
            base = torch.zeros(pr["rows"], dtype=torch.float32, device=src.device)
            lib = (lambda: base.clone().index_add_(0, idx, vals))
            note = "index_add_ of the bf16 values: the row sums, before the broadcast"
            want = out[0][:, 0]
    elif k is F.copy and pr["mode"] != F.CP_PREFETCH:
        # into a buffer holding UNWRITTEN, as the wrapper's output does; the
        # offset is read on the host once, before the timed calls
        src = pos[0]
        buf = torch.full_like(out[0], L.UNWRITTEN)
        if pr["mode"] == F.CP_DMA:
            frm, n = int(pos[1][0]), F.CP_ROWS[F.CP_DMA]
            dst = buf[frm + 8:frm + 8 + n]
            lib = (lambda: torch.mul(src[frm:frm + n], 2, out=dst))
            note = "torch.mul(rows, 2, out=) at the offset"
        else:
            lib = (lambda: buf[0].copy_(src.reshape(-1)))
            note = "Tensor.copy_ of the flattened rows into row 0"
        lib()
        check(torch.equal(buf, want), f"{note} differs from {form.name}'s output")
        return cuda_ms(lib, 5), note
    if lib is None:
        return None, "none: no single PyTorch call computes it"
    got = lib()
    check(torch.equal(got.to(want.dtype), want),
          f"{note} differs from {form.name}'s output")
    return cuda_ms(lib, 5), note


def phase_form_probes():
    """The single-shot capability forms and the streaming decoder's probes
    (``webgraph_tpu_torch/probes``: ``caps``, ``bisect``, ``bisect2``,
    ``v6``, ``v6b``, the counterparts of the JAX package's
    ``scripts/pallas_caps_probe.py``, ``pallas_bisect_probe.py``,
    ``pallas_bisect2.py``, ``v6_probe.py`` and ``v6_probe2.py``; the seven
    kernels of ``csrc/forms.cu`` and five of ``csrc/loops.cu``: the three v6
    kernels, and :data:`FORM_LOOP_KERNELS` for bisect2's two loops) on the
    scripts' inputs at their on-chip sizes, none cut (P3 65,536 trips,
    fn200's 20 calls, ``K`` 512).  The probe path is each module's
    ``run("cuda")`` with every launch count reset just before and read
    just after; each form is held to the script's own check there.  Then each form is held to its
    plain version exactly (dtypes too), each loop run at
    :data:`LOOP_PLAIN_REPS` loops or fewer, each kernel's own device time
    traced (None where every trace dropped its records), its bound computed
    (:func:`_form_work`, :func:`_v6_work`) and, where one PyTorch call
    computes the form or one rep of a loop, that call timed
    (:func:`_form_library`, :func:`_body_library`).  Returns each kernel's
    row, its runs under ``"runs"``; main() adds the rows of
    :data:`FORM_LOOP_KERNELS` to phase_loop_probes'."""
    import torch

    from webgraph_tpu_torch.probes import bisect, bisect2, caps, v6, v6b
    from webgraph_tpu_torch.probes import forms as F
    from webgraph_tpu_torch.probes import loops as L
    from webgraph_tpu_torch.timing import NoWholeRun, kernel_ms

    dev = torch.device("cuda")
    wrappers = {**F.KERNELS, **L.V6_KERNELS, **{k: L.KERNELS[k] for k in FORM_LOOP_KERNELS}}
    modules = {"caps": caps, "bisect": bisect, "bisect2": bisect2, "v6": v6, "v6b": v6b}
    for w in wrappers.values():
        w.launches = 0
    res = {m: M.run("cuda") for m, M in modules.items()}
    launches = {k: w.launches for k, w in wrappers.items()}
    print("form probe path launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(all(v >= 1 for v in launches.values()),
          f"a form probe kernel was not launched on the probe path: {launches}")
    rows = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "device_ms_at_plain_reps": 0.0, "reps": 0, "plain_reps": 0,
                "launches": launches[k], "library_ms": None, "library_note": None,
                "runs": {}} for k in wrappers}

    def device_time(fn, kernel, n_launch, what):
        try:  # a measurement only: the trace may drop a kernel's records
            return kernel_ms(fn, 5, (kernel,))[kernel] * n_launch
        except NoWholeRun as exc:
            print(f"{what}: device time not measured ({exc})")
            return None

    def add(kernel, what, one, err, lib_ms, note):
        agg = rows[kernel]
        agg["runs"][what] = one
        for key in ("ms", "plain_ms", "bound_ms", "device_ms_at_plain_reps"):
            v = one[key]
            agg[key] = None if v is None or agg[key] is None else agg[key] + v
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["reps"] += one["reps"]
        agg["plain_reps"] += one["plain_reps"]
        if agg["library_ms"] is None and lib_ms is not None:
            agg["library_ms"], agg["library_note"] = lib_ms, f"{what}: {note}"

    for m, M in modules.items():
        for f in (M.forms() if hasattr(M, "forms") else ()):
            r = res[m][f.name]
            what = f"{m}/{f.name}"
            check(r["ok"] is not False, f"{what}: {r['kernel']} fails the script's check")
            args = f.tensors(dev)
            out = f.call(args)
            err = _exact(out, f.call(args, plain=True))
            check(err == 0, f"{what}: {r['kernel']} differs from its plain version "
                            f"(max |err| {err})")
            _, plain_ms = _events_ms(lambda: f.call(args, plain=True))
            torch.cuda.synchronize()
            device = device_time(lambda: f.call(args), r["kernel"], 1, what)
            bound_ms, bound_by = _bound(*_form_work(f, args, out))
            lib_ms, note = _form_library(f, args, out)
            print(f"{what}: {r['kernel']} exact vs plain and the script's check "
                  f"({r['ok']}); {r['ms']:.4f} ms, device "
                  + ("not measured" if device is None else f"{device:.4f} ms")
                  + f", bound {bound_ms:.6f} ms ({bound_by}), plain {plain_ms:.4f} ms"
                  + ("" if lib_ms is None else f"; {note} {lib_ms:.4f} ms"))
            trips = f.params.get("reps", 1)  # bisect2's loops: their trips
            add(r["kernel"], what, {
                "reps": trips, "plain_reps": trips, "ms": r["ms"],
                "device_ms_at_plain_reps": device,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "script_check": r["ok"], "library_ms": lib_ms}, err, lib_ms, note)
        for p in (M.probes() if hasattr(M, "probes") else ()):
            r = res[m][p.name]
            what = f"{m}/{p.name}"
            args = p.tensors(dev)
            n = min(r["reps"], LOOP_PLAIN_REPS)
            err = _exact(p.call(args, n), p.call(args, n, plain=True))
            check(err == 0, f"{what}: {r['kernel']} differs from its plain version "
                            f"(max |err| {err})")
            _, plain_ms = _events_ms(lambda: p.call(args, n, plain=True))
            torch.cuda.synchronize()
            calls = n if p.kernel is L.v6_fetch else 1  # fn200: a launch a call
            device = device_time(lambda: p.call(args, n), r["kernel"], calls, what)
            bound_ms, bound_by = _bound(*_v6_work(p, r["reps"]))
            lib_ms, note = (_body_library(p, args) if p.kernel is L.body_loop
                            else (None, "none: no single PyTorch call computes it"))
            per_rep = L.cost(r).strip()
            print(f"{what}: {r['kernel']} exact vs plain at {n}; {r['reps']} reps "
                  f"{r['ms']:.4f} ms ({per_rep}), bound {bound_ms:.6f} ms ({bound_by}), "
                  f"plain {plain_ms:.4f} ms at {n}"
                  + ("" if lib_ms is None else f"; {note} {lib_ms:.4f} ms a call"))
            add(r["kernel"], what, {
                "reps": r["reps"], "script_reps": p.reps, "plain_reps": n, "ms": r["ms"],
                "per_rep": per_rep, "device_ms_at_plain_reps": device, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms},
                err, lib_ms, note)
    for agg in rows.values():
        worst = max(agg["runs"].values(), key=lambda x: x["bound_ms"])
        agg["bound_by"] = worst["bound_by"]
        agg["library_note"] = agg["library_note"] or "none: no single PyTorch call computes it"
    return rows


def phase_k2_small(tmp):
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels.plan import scan_structure

    graphs = _k2_graphs()
    for name, g, kw, k2_only in graphs:
        bv = _store(g, tmp, name, **kw)
        scan = scan_structure(bv)
        if k2_only:
            check(not D2.supports(bv, scan), f"K2 {name}: K1 supports it")
        prep = K2.prepare(bv, "cuda", scan=scan)
        succ, *_ = _vs_plain(prep, K2.decode_levels, K2.parse_records)
        _csr_vs_oracle(bv, prep.offsets, succ, f"K2 {name}")
        print(f"K2 small {name}: n {bv.num_nodes()} m {bv.num_arcs()} "
              f"levels {len(prep.bounds) - 1} exact vs plain and oracle")
    print(f"K2 small: {len(graphs)} graphs exact vs plain decoder and oracle")


def _level_bounds(bv, scan, order, bounds, nlong, stream_bytes):
    """Bounds (ms, what bounds it) of a route's parse and copy kernels over
    the records of ``order`` (node ids in depth order, int64; every node
    for a bulk decode, a batch's ancestor closure for a query) split by
    ``bounds``, ``nlong`` of them long, whose stream the parse reads as
    ``stream_bytes``: what each kernel must read and write once, and one
    operation per code read (parse) or arc written (copy)."""
    import numpy as np

    n = order.size
    b1 = int(bounds[1]) if len(bounds) > 1 else n
    d = scan.d.astype(np.int64)
    ref = scan.ref.astype(np.int64)
    copied = np.where(ref > 0, scan.copied.astype(np.int64), 0)
    blocks = scan.block_count.astype(np.int64)
    nblocks = int(blocks[order].sum())
    extras = int((d[order] - copied[order]).sum())
    deep = order[b1:]
    idx = 8 * (n + 1)  # one int64 index array (bo, offsets, bstart)
    # parse: the stream, bo, offsets, bstart, order and the long records'
    # positions in; the extras, block ends, rank, reference, extras count
    # and error out
    parse = (stream_bytes + 3 * idx + 4 * n + 4 * nlong
             + 4 * (extras + nblocks) + 4 * 4 * n)
    # copy: offsets, bstart, the deep nodes' order slots, reference,
    # extras count, error, rank of their parents, their extras and block
    # ends, the copied arcs of their parents in; their lists out
    copy = (2 * idx + 6 * 4 * len(deep)
            + 4 * int((d[deep] - copied[deep]).sum())
            + 4 * int(blocks[deep].sum())
            + 4 * int(copied[deep].sum()) + 4 * int(d[deep].sum()))
    return (_bound(parse, _codes(bv, scan, order) + extras),
            _bound(copy, int(d[deep].sum())))


def _prep_bounds(bv, prep, scan):
    """:func:`_level_bounds` of a bulk decode's plan: every record, the
    whole stream."""
    nlong = prep.long.numel() if hasattr(prep, "long") else 0
    return _level_bounds(bv, scan, prep.order.long().cpu().numpy(),
                         prep.bounds, nlong, prep.words.numel() * 8)


def phase_k2_main(bv, label, card):
    """K2's main path: the public entry point on a graph K1 does not take,
    counted, checked, then timed with planning excluded."""
    import numpy as np
    import torch

    import webgraph_tpu_torch as wgt
    from webgraph_tpu_torch.formats import bvgraph as F
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels.plan import scan_structure
    from webgraph_tpu_torch.timing import cuda_ms, kernel_ms

    n, m = bv.num_nodes(), bv.num_arcs()
    t0 = time.perf_counter()
    scan = scan_structure(bv)
    scan_s = time.perf_counter() - t0
    check(not D2.supports(bv, scan), f"{label}: K1 supports it")
    depth = scan.depth.astype(np.int64)
    reach = int((np.arange(n) - D2._minanc(scan, n)).max(initial=0))
    t0 = time.perf_counter()
    prep = F.prepare(bv, "cuda")
    plan_s = time.perf_counter() - t0
    check(isinstance(prep, K2.LevelPrepared), f"{label}: not routed to K2")
    sizes = np.diff(prep.bounds)
    levels = len(sizes)

    # the main path, through the public entry point, counted
    _reset_counts()
    off, succ = wgt.decode_to_csr(bv, device="cuda")
    torch.cuda.synchronize()
    c = _counts()
    k1 = sum(c["k1"].values())
    kp, kr, probes = c["k2"]["k2_parse"], c["k2"]["k2_resolve"], c["probes"]
    k2 = kp + kr
    check(k1 == 0 and kp == 1 and kr == 1 and probes == 0,
          f"{label}: launches {c}; levels {levels}")
    _csr_vs_oracle(bv, off, succ, label)

    # timing, planning excluded: warm-up, then median of 5; each kernel's
    # device time from 5 traced decodes
    F.decode_prepared(prep)
    decode_ms = cuda_ms(lambda: F.decode_prepared(prep), 5)
    kms = kernel_ms(
        lambda: K2.decode_levels(*prep.args(), **prep.sizes()), 5,
        ("k2_parse", "k2_resolve"))
    ksucc, perr, rerr, parse_plain, resolve_plain = _vs_plain(
        prep, K2.decode_levels, K2.parse_records)
    check(torch.equal(ksucc, succ), f"{label}: K2 runs differ")
    (pb, pby), (rb, rby) = _prep_bounds(bv, prep, scan)
    print(f"{label}: n {n} m {m} reach {reach} max depth {int(depth.max())} "
          f"levels {levels} (nodes per level: median "
          f"{float(np.median(sizes)):.0f}, max {int(sizes.max())}; "
          f"{int((depth < 100).sum())} nodes at depth < 100); scan "
          f"{scan_s:.2f} s, plan {plan_s:.2f} s")
    print(f"{label}: launches K1's wrapper {k1} K2's {k2} (k2_parse {kp}, "
          f"k2_resolve "
          f"{kr}); decode {decode_ms:.4f} ms = {m / decode_ms / 1e3:.2f} "
          f"Medges/s; k2_parse {kms['k2_parse']:.4f} ms (bound {pb:.4f} ms, "
          f"{pby}), k2_resolve {kms['k2_resolve']:.4f} ms (bound {rb:.4f} "
          f"ms, {rby}; {kms['k2_resolve'] / max(levels - 1, 1) * 1e3:.3f} "
          f"us a link of the {levels - 1}-link chain); plain "
          f"{parse_plain:.1f} + {resolve_plain:.1f} ms; card {card}")
    return {
        "k2_parse": {"launches": kp, "max_abs_err": perr,
                     "ms": kms["k2_parse"], "plain_ms": parse_plain,
                     "bound_ms": pb, "bound_by": pby},
        "k2_resolve": {"launches": kr, "max_abs_err": rerr,
                       "ms": kms["k2_resolve"], "plain_ms": resolve_plain,
                       "bound_ms": rb, "bound_by": rby},
        "csr": (off, succ),
        "scan": scan,
    }


# batch sizes of the query phase: the reference's lane count (1,024),
# smaller batches for latency, and one that fills more of the card
QUERY_BATCHES = (1, 16, 64, 1024, 16384)
QUERY_VS_PLAIN = 1024  # the batch whose kernels are held to the plain ones


def _ragged(starts, counts):
    """(row, index in row, flat position) of every item of rows of
    ``counts`` items starting at ``starts`` (int64 NumPy arrays)."""
    import numpy as np

    row = np.repeat(np.arange(counts.size), counts)
    j = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts,
                                                 counts)
    return row, j, starts[row] + j


def _query_vs_plain(qp, plan):
    """The 1,024 batch's kernels against their plain versions on the same
    subset, on the card: ``k1_parse`` alone against ``parse_records_plain``
    in the closure's slots (extras, block ends, references, errors) and
    the decode against ``resolve_copies_plain`` in the closure's list
    slots.  Returns (parse max |err|, copy max |err|, plain parse ms,
    plain copy ms)."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels import levels as L

    order = torch.from_numpy(plan.order.astype(np.int32)).cuda()
    long = torch.from_numpy(plan.long.astype(np.int32)).cuda()
    args = (qp.words, qp.bo, order, plan.bounds, qp.offsets, qp.skey,
            qp.bstart)
    sizes = dict(m=qp.m, nblocks=qp.nblocks)
    parsed = D2.parse_records(*args, long, **sizes)
    plain, parse_ms = _events_ms(lambda: L.parse_records_plain(*args,
                                                                **sizes))
    offsets = qp.offsets.cpu().numpy()
    bstart = qp.bstart.cpu().numpy()
    x = plan.order
    slots = torch.from_numpy(_ragged(offsets[x], np.diff(offsets)[x])[2])
    blocks = torch.from_numpy(_ragged(bstart[x], np.diff(bstart)[x])[2])
    nodes = order.long()
    perr = 0
    for name, idx in (("ext", slots.cuda()), ("bend", blocks.cuda()),
                      ("ref", nodes), ("err", None)):
        got, want = getattr(parsed, name), getattr(plain, name)
        if idx is not None:
            got, want = got[idx], want[idx]
        if got.numel():
            perr = max(perr, int((got.long() - want.long()).abs().max()))
    check(perr == 0, f"query parse differs from plain (max |err| {perr})")
    succ = qp.decode(plan)
    (psucc, err), copy_ms = _events_ms(lambda: L.resolve_copies_plain(
        plain, order, plan.bounds, qp.offsets, qp.bstart, m=qp.m))
    L.check_errors(err, order)
    s = slots.cuda()
    cerr = int((succ[s].long() - psucc[s].long()).abs().max()) \
        if s.numel() else 0
    check(cerr == 0, f"query copies differ from plain (max |err| {cerr})")
    return perr, cerr, parse_ms, copy_ms


def phase_query(bv, label, card, csr, scan):
    """Batched random access on a cell at size
    (``kernels/query2.QueryPlanner``): for each of :data:`QUERY_BATCHES`
    nodes drawn by ``XoRoShiRo128PlusRandom(0)``, ``successors_batch``
    with the counters reset just before and read just after (``k1_parse``
    1, ``k2_resolve`` 1 unless the closure is all at depth 0, K2's wrapper
    0), exact against the bulk decode's CSR ``csr`` (itself checked
    against the oracle), then timed: the host plan, each kernel's device
    time, the whole batch (synchronised), ns a queried node.  The 1,024
    batch's kernels are held to their plain versions on the same subset.
    Returns the 1,024 batch's kernel rows and the launches of every
    counted run."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.kernels.query2 import QueryPlanner
    from webgraph_tpu_torch.timing import kernel_ms
    from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom

    toff, tsucc = (t.cpu().numpy() for t in csr)
    n = bv.num_nodes()
    t0 = time.perf_counter()
    qp = QueryPlanner(bv, "cuda", scan=scan)
    setup_s = time.perf_counter() - t0
    launches = {"k1_parse": 0, "k2_resolve": 0}
    rows = None
    for size in QUERY_BATCHES:
        rng = XoRoShiRo128PlusRandom(0)
        nodes = np.array([rng.next_int(n) for _ in range(size)], np.int64)
        plan = qp.plan(nodes)
        deep = plan.bounds.size > 2

        # the query path, counted
        _reset_counts()
        out, counts = qp.successors_batch(nodes)
        torch.cuda.synchronize()
        c = _counts()
        check(c["k1"] == {"k1_parse": 1, "k2_resolve": int(deep)}
              and not any(c["k2"].values()) and c["probes"] == 0,
              f"{label} query {size}: launches {c}")
        for k in launches:
            launches[k] += c["k1"][k]
        d = np.diff(toff)[nodes]
        row, j, src = _ragged(toff[nodes], d)
        want = np.zeros((size, max(int(d.max(initial=1)), 1)), np.int32)
        want[row, j] = tsucc[src]
        check(np.array_equal(counts.cpu().numpy(), d)
              and np.array_equal(out.cpu().numpy(), want),
              f"{label} query {size}: lists differ from the bulk decode")

        # timing: the host plan, each kernel, the whole batch
        plan_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            qp.plan(nodes)
            plan_ms.append((time.perf_counter() - t0) * 1e3)
        names = ("k1_parse", "k2_resolve") if deep else ("k1_parse",)
        kms = {"k2_resolve": 0.0, **kernel_ms(lambda: qp.decode(plan), 5,
                                              names)}
        batch_ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qp.successors_batch(nodes)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        bms = float(np.median(batch_ms[1:]))
        print(f"{label} query batch {size}: closure {plan.order.size} nodes "
              f"({plan.bounds.size - 1} depths, {plan.long.size} long), "
              f"{int(d.sum())} arcs, launches k1_parse 1 k2_resolve "
              f"{int(deep)}, exact vs bulk; plan "
              f"{float(np.median(plan_ms)):.4f} ms, k1_parse "
              f"{kms['k1_parse']:.4f} ms, k2_resolve {kms['k2_resolve']:.4f} "
              f"ms, batch {bms:.4f} ms = {bms * 1e6 / size:.1f} ns/node; "
              f"card {card}")
        if size == QUERY_VS_PLAIN:
            perr, cerr, parse_plain, copy_plain = _query_vs_plain(qp, plan)
            bits = np.asarray(bv.bit_offsets, np.int64)
            stream = int((bits[plan.order + 1] - bits[plan.order]).sum()) // 8
            (pb, pby), (cb, cby) = _level_bounds(
                bv, scan, plan.order, plan.bounds, plan.long.size, stream)
            rows = {
                "k1_parse": {"max_abs_err": perr, "ms": kms["k1_parse"],
                             "plain_ms": parse_plain, "bound_ms": pb,
                             "bound_by": pby},
                "k2_resolve": {"max_abs_err": cerr, "ms": kms["k2_resolve"],
                               "plain_ms": copy_plain, "bound_ms": cb,
                               "bound_by": cby},
            }
            print(f"{label} query batch {size}: kernels exact vs plain on "
                  f"the closure; k1_parse bound {pb:.6f} ms ({pby}), "
                  f"k2_resolve bound {cb:.6f} ms ({cby}); plain "
                  f"{parse_plain:.1f} + {copy_plain:.1f} ms")
    print(f"{label} query: planner set-up {setup_s:.2f} s; launches over "
          f"the {len(QUERY_BATCHES)} counted batches {launches}")
    return {k: {**v, "launches": launches[k], "library_ms": None}
            for k, v in rows.items()}

# the analytics phase: single-source BFS runs, NF and geometric batches of
# 64 sources, one betweenness batch, NF sources held to host BFS sums, the
# nodes of the web-like graph whose symmetrization SumSweep sweeps, and
# those of the directed web-like graph it sweeps forward and backward: the
# smallest of the generator's sizes at which SumSweep sweeps every node
# (15,517 BFS runs; at 20,000 nodes 39,977, too long for the host path
# that checks it)
BFS_SOURCES = 6
NF_BATCHES = 4
GEO_BATCHES = 2
BC_BATCH = 16
NF_VS_HOST = 8
SUMSWEEP_NODES = 20_000
SUMSWEEP_DIRECTED_NODES = 8_000


def _pull_bytes(n, m, k=1, levels=1, perbit=False):
    """Bytes ``levels`` levels of ``or_pull`` over ``k`` words a node must
    move: a level reads the in-CSR (int64 offsets, int32 sources) once and
    the old words once (the gathers of in-arc sources repeat them; at 8 k n
    bytes they stay in the card's L2), writes the new ones and the level's
    counts."""
    return levels * (8 * (n + 1) + 4 * m + 2 * 8 * k * n
                     + 8 * k * (65 if perbit else 1))


def _trace_busy(fn, launches=0):
    """(device ms, or_pull ms of each launch) of one run of ``fn`` under
    ``torch.profiler``, device activity only: the summed durations of its
    kernels, copies and memsets, and of its ``or_pull`` launches.  A trace
    that holds no device activity, or fewer than ``launches`` ``or_pull``
    launches (the profiler dropped records), is taken again, up to
    ``timing.TRACES`` times; then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from webgraph_tpu_torch.timing import TRACES

    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as t:
            fn()
            torch.cuda.synchronize()
        dur = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in t.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        pulls = [d for k, d in dur if "or_pull" in k]
        if dur and len(pulls) >= launches:
            return sum(d for _, d in dur), pulls
    return None, []


def _with_plain_pull(fn):
    """``fn()`` with ``algo.device`` propagating through
    ``propagate_plain``."""
    from webgraph_tpu_torch.algo import device as A
    from webgraph_tpu_torch.kernels import propagate as P

    A.propagate = lambda *args, order, **kw: P.propagate_plain(*args, **kw)
    try:
        return fn()
    finally:
        A.propagate = P.propagate


# words a node at which a level of or_pull is timed alone
LEVEL_KS = (1, 4, 8, 16)


def phase_analytics(bv, label, card, csr_bulk):
    """The device transforms and analytics on the K1 cell at size, after
    its bulk decode (``csr_bulk``, checked against the oracle): the graph
    to the card with ``DeviceCSR.from_graph(bv)`` (``k1_parse`` 1,
    ``k2_resolve`` 1), transpose / symmetrize / map, BFS from
    :data:`BFS_SOURCES` nodes, :data:`NF_BATCHES` NF batches,
    :data:`GEO_BATCHES` geometric batches, one betweenness batch, and
    SumSweep on the symmetrized web-like graph of :data:`SUMSWEEP_NODES`
    nodes and on the directed one of :data:`SUMSWEEP_DIRECTED_NODES`, with
    every count reset just before and read just after: one ``or_pull``
    launch and one host read a BFS (SumSweep's too), a group of
    ``algo.device.GROUP`` NF or geometric batches.  Each is exact against
    the host copies, or against the same function through
    ``propagate_plain`` on the card (or on CPU tensors, betweenness), then
    timed: CUDA-event ms (median of 3 more runs; SumSweep's one counted
    run), ``or_pull`` launches and ms a launch, host reads, levels run, the
    bound (levels x a level's bytes), the busy share (device time in a
    traced run over that ms; not traced for the directed SumSweep).  Then
    ``or_pull`` alone: one level against ``or_pull_plain`` and timed at
    :data:`LEVEL_KS` words a node, a BFS's one launch, and a 4-word
    propagation with per-bit counts and distances against
    ``propagate_plain``.  Returns ``or_pull``'s kernel row."""
    import numpy as np
    import torch

    from webgraph_tpu_torch.algo import device as A
    from webgraph_tpu_torch.algo.bfs import bfs_distances as host_bfs
    from webgraph_tpu_torch.algo.sumsweep import (
        OutputLevel, SumSweepDirectedDiameterRadius)
    from webgraph_tpu_torch.graph.csr import CSRGraph
    from webgraph_tpu_torch.kernels import _build
    from webgraph_tpu_torch.kernels import propagate as P
    from webgraph_tpu_torch.synth import weblike_graph
    from webgraph_tpu_torch.timing import cuda_ms, kernel_ms
    from webgraph_tpu_torch.transform import device as TD
    from webgraph_tpu_torch.transform import transform as T
    from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom

    n, m = bv.num_nodes(), bv.num_arcs()
    toff, tsucc = (t.cpu().numpy() for t in csr_bulk)
    host = CSRGraph(toff, tsucc)
    rng = XoRoShiRo128PlusRandom(0)
    sources = [rng.next_int(n) for _ in range(BFS_SOURCES)]
    perm = T.random_permutation(host, seed=0)
    g20 = T.symmetrize(weblike_graph(SUMSWEEP_NODES))
    gdir = weblike_graph(SUMSWEEP_DIRECTED_NODES)
    ops = {}

    def step(name, fn):
        """``fn()`` once, timed by CUDA events, its launches, reads and
        levels."""
        pulls, reads = P.or_pull.launches, sum(A.host_reads.values())
        levels = P.propagate.levels
        out, ms = _events_ms(fn)
        ops[name] = {"fn": fn, "ms": ms,
                     "launches": P.or_pull.launches - pulls,
                     "reads": sum(A.host_reads.values()) - reads,
                     "run": P.propagate.levels - levels}
        return out

    bfs_calls = []  # SumSweep's BFS runs, by the device BFS it calls
    device_bfs = A.bfs_distances

    def counted_bfs(*args, **kw):
        bfs_calls.append(1)
        return device_bfs(*args, **kw)

    def sumsweep(g, use_device):
        s = SumSweepDirectedDiameterRadius(
            g, OutputLevel.RADIUS_DIAMETER, use_device=use_device)
        s.compute()
        return s.get_diameter(), s.get_radius(), s.iterations

    # the analytics path, counted
    _reset_counts()
    P.or_pull.launches = 0
    for k in A.host_reads:
        A.host_reads[k] = 0
    csr = step("from_graph", lambda: A.DeviceCSR.from_graph(bv, "cuda"))
    c = _counts()
    pm = torch.as_tensor(perm, device="cuda")
    tr = step("transpose",
              lambda: TD.transpose_arcs_device(csr.src, csr.dst, n))
    sy = step("symmetrize",
              lambda: TD.symmetrize_arcs_device(csr.src, csr.dst, n))
    mp = step("map", lambda: TD.map_arcs_device(csr.src, csr.dst, pm, n))
    dists = [step(f"bfs {s}", lambda s=s: A.bfs_distances(csr, s))
             for s in sources]
    nf_counts, nf_deep = step(
        "nf", lambda: A.make_nf_batches(csr, n)(0, NF_BATCHES))
    geo = step("geometric", lambda: A.make_geometric_batches(
        csr, n, 0.5)(0, GEO_BATCHES))
    bc = step("betweenness",
              lambda: A.make_betweenness_batches(csr, n, BC_BATCH)(0))
    A.bfs_distances = counted_bfs
    try:
        ss = step("sumsweep", lambda: sumsweep(g20, True))
        ops["sumsweep"]["bfs"] = len(bfs_calls)
        ssd = step("sumsweep directed", lambda: sumsweep(gdir, True))
        ops["sumsweep directed"]["bfs"] = (len(bfs_calls)
                                           - ops["sumsweep"]["bfs"])
    finally:
        A.bfs_distances = device_bfs
    torch.cuda.synchronize()
    launches = P.or_pull.launches
    reads = dict(A.host_reads)
    c2 = _counts()
    check(c == c2 and c["k1"] == {"k1_parse": 1, "k2_resolve": 1}
          and not any(c["k2"].values()) and c["probes"] == 0,
          f"{label} analytics: decode launches {c} then {c2}")
    check(launches == sum(o["launches"] for o in ops.values()) > 0,
          f"{label} analytics: or_pull launches {launches}")
    # one launch and one host read a propagation (none runs past a level
    # array here): a BFS, a group of batches, a BFS of SumSweep's
    props = {f"bfs {s}": 1 for s in sources}
    props["nf"] = -(-NF_BATCHES // A.GROUP)
    props["geometric"] = -(-GEO_BATCHES // A.GROUP)
    props["sumsweep"] = ops["sumsweep"]["bfs"]
    props["sumsweep directed"] = ops["sumsweep directed"]["bfs"]
    for name, w in props.items():
        check(ops[name]["launches"] == ops[name]["reads"] == w,
              f"{label} analytics {name}: {ops[name]['launches']} launches, "
              f"{ops[name]['reads']} host reads, {w} propagations")

    # exact against the host copies and the plain versions
    check(torch.equal(csr.offsets, csr_bulk[0].long())
          and torch.equal(csr.dst, csr_bulk[1]),
          f"{label} analytics: from_graph's CSR differs from the bulk decode")
    for name, got, ref in (("transpose", tr, T.transpose(host)),
                           ("symmetrize", sy, T.symmetrize(host)),
                           ("map", mp, T.map_graph(host, perm))):
        roff, rsucc = ref.to_csr()
        k = int(got[2])
        check(np.array_equal(got[0].cpu().numpy(), roff)
              and np.array_equal(got[1][:k].cpu().numpy(), rsucc),
              f"{label} analytics: {name} differs from the host copy")
        ops[name]["arcs"] = k
    check(torch.equal(csr.in_off, tr[0]) and torch.equal(csr.in_src, tr[1]),
          f"{label} analytics: DeviceCSR's in-CSR differs from transpose")
    for s, d in zip(sources, dists):
        check(np.array_equal(d.cpu().numpy(), host_bfs(host, s)),
              f"{label} analytics: BFS from {s} differs from the host copy")
        ops[f"bfs {s}"]["levels"] = int(d.max())
    pc, pdeep = _with_plain_pull(
        lambda: A.make_nf_batches(csr, n)(0, NF_BATCHES))
    check(pdeep == nf_deep and np.array_equal(pc, nf_counts),
          f"{label} analytics: NF batches differ from propagate_plain's")
    few = np.arange(NF_VS_HOST)
    counts, _, it = A.nf64(csr, few)
    want = np.zeros(it + 1, np.int64)
    for s in few:
        d = host_bfs(host, int(s))
        want += ((d[None, :] >= 0)
                 & (d[None, :] <= np.arange(it + 1)[:, None])).sum(axis=1)
    check(np.array_equal(counts, want),
          f"{label} analytics: NF of {NF_VS_HOST} sources differs from "
          f"host BFS sums")
    pgeo = _with_plain_pull(lambda: A.make_geometric_batches(
        csr, n, 0.5)(0, GEO_BATCHES))
    for a, b in zip(geo, pgeo):
        check(torch.allclose(a.double(), b.double(), rtol=1e-12, atol=0)
              and (a.is_floating_point() or torch.equal(a, b)),
              f"{label} analytics: geometric batches differ from plain")
    t0 = time.perf_counter()
    ccsr = A.DeviceCSR(toff, tsucc, n, "cpu")
    cbc = A.make_betweenness_batches(ccsr, n, BC_BATCH)(0)
    bc_cpu_s = time.perf_counter() - t0
    check(torch.allclose(bc.cpu(), cbc, rtol=1e-9, atol=1e-9),
          f"{label} analytics: betweenness batch differs from CPU tensors")
    t0 = time.perf_counter()
    for name, got, g in (("", ss, g20), (" directed", ssd, gdir)):
        check(got == sumsweep(g, False),
              f"{label} analytics: SumSweep{name} differs from the host path")
    ss_host_s = time.perf_counter() - t0

    # or_pull alone at the path's shapes: batch 0's words after 3 steps,
    # one level against the plain version (the one-step entry)
    words = A._batch_masks(csr, torch.arange(64, device="cuda")).view(-1)
    for _ in range(3):
        words, _ = P.or_pull(csr.in_off, csr.in_src, words)
    new, stats = P.or_pull(csr.in_off, csr.in_src, words, perbit=True)
    pnew, pstats = P.or_pull_plain(csr.in_off, csr.in_src, words,
                                   perbit=True)
    check(torch.equal(new, pnew) and torch.equal(stats, pstats),
          f"{label} analytics: or_pull differs from or_pull_plain")
    err = int((stats - pstats).abs().max())
    call_ms = cuda_ms(lambda: P.or_pull(csr.in_off, csr.in_src, words,
                                        perbit=True), 20)
    ms = kernel_ms(lambda: P.or_pull(csr.in_off, csr.in_src, words,
                                     perbit=True), 20, ("or_pull",))["or_pull"]
    plain_ms = cuda_ms(lambda: P.or_pull_plain(
        csr.in_off, csr.in_src, words, perbit=True), 3)
    bits = P.unpack_bits(words)
    gathered = bits[csr.in_src.long()]
    idx = P._in_targets(csr.in_off).unsqueeze(1).expand(-1, 64)
    pulled = torch.zeros_like(bits)
    library_ms = cuda_ms(
        lambda: pulled.scatter_reduce_(0, idx, gathered, "amax"), 5)
    del bits, gathered, idx, pulled
    bound_ms, bound_by = _bound(_pull_bytes(n, m, perbit=True), m + n)

    # a level alone at k words a node (batches 0..k-1 after 3 levels), and
    # a BFS's one launch
    level_ms, level_bound = {}, {}
    for k in LEVEL_KS:
        wk = P.propagate(csr.in_off, csr.in_src, A._group_words(csr, 0, k),
                         max_levels=3, order=csr.pull).words
        level_ms[k] = kernel_ms(lambda: P.propagate(
            csr.in_off, csr.in_src, wk, max_levels=1, order=csr.pull), 10,
            ("or_pull",))["or_pull"]
        level_bound[k] = _bound(_pull_bytes(n, m, k), k * (m + n))[0]
    s0 = sources[0]
    bfs_levels = ops[f"bfs {s0}"]["run"]
    bfs_ms = kernel_ms(lambda: A.bfs_distances(csr, s0), 5,
                       ("or_pull",))["or_pull"]
    bfs_bound = _bound(_pull_bytes(n, m, levels=bfs_levels), 0)[0]

    # a whole 4-word propagation with per-bit counts and distances against
    # the plain version
    w4 = A._group_words(csr, 0, 4)
    d1 = torch.full(w4.shape, -1, dtype=torch.int32, device="cuda")
    d2 = d1.clone()
    got = P.propagate(csr.in_off, csr.in_src, w4, max_levels=n, perbit=True,
                      dist=d1, order=csr.pull)
    want4 = P.propagate_plain(csr.in_off, csr.in_src, w4, max_levels=n,
                              perbit=True, dist=d2)
    check(got.levels == want4.levels
          and torch.equal(got.words, want4.words)
          and torch.equal(got.counts, want4.counts)
          and torch.equal(got.bits, want4.bits) and torch.equal(d1, d2),
          f"{label} analytics: a 4-word propagation differs from "
          f"propagate_plain")
    err = max(err, int((got.bits - want4.bits).abs().max()))
    prop_levels = got.levels
    blocks = [_build.load().wgt_or_pull_blocks(pb) for pb in (0, 1)]

    # bounds (levels run x a level's bytes), busy shares, or_pull's ms a
    # launch in the path
    # the betweenness batch's forward levels (a read each, the last finds
    # no frontier) and its backward levels, one fewer
    bc_levels = ops["betweenness"]["reads"]
    bounds = {
        "from_graph": (int(np.asarray(bv.bit_offsets)[-1]) + 7) // 8
        + 2 * 8 * (n + 1)
        + 3 * 4 * m,
        "transpose": 8 * m + 8 * (n + 1) + 4 * m,
        "symmetrize": 8 * m + 8 * (n + 1) + 4 * ops["symmetrize"]["arcs"],
        "map": 8 * m + 8 * n + 8 * (n + 1) + 4 * ops["map"]["arcs"],
        "nf": _pull_bytes(n, m, min(A.GROUP, NF_BATCHES), ops["nf"]["run"]),
        "geometric": _pull_bytes(n, m, min(A.GROUP, GEO_BATCHES),
                                 ops["geometric"]["run"], perbit=True),
        "betweenness": (bc_levels * (8 * m + 12 * BC_BATCH * n)
                        + (bc_levels - 1) * (8 * m + 16 * BC_BATCH * n)),
        "sumsweep": _pull_bytes(g20.num_nodes(), g20.num_arcs(),
                                levels=ops["sumsweep"]["run"]),
        "sumsweep directed": _pull_bytes(
            gdir.num_nodes(), gdir.num_arcs(),
            levels=ops["sumsweep directed"]["run"]),
    }
    for s in sources:
        bounds[f"bfs {s}"] = _pull_bytes(n, m, levels=ops[f"bfs {s}"]["run"])
    # SumSweep keeps its one counted run; the directed sweep's trace would
    # hold some 10^5 launches, more than the smoke has time to read
    for name, o in ops.items():
        if not name.startswith("sumsweep"):
            o["ms"] = cuda_ms(o["fn"], 3)
        busy, pulls = None, []
        if name != "sumsweep directed":
            busy, pulls = _trace_busy(o["fn"], o["launches"])
        b_ms, b_by = _bound(int(bounds[name]), 0)
        extra = ""
        if "levels" in o:
            extra = f", eccentricity {o['levels']}"
        if o.get("run"):
            extra += f", levels run {o['run']}"
        if "bfs" in o:
            extra += f", {o['bfs']} BFS"
        if "arcs" in o:
            extra = f", {o['arcs']} arcs out"
        print(f"{label} analytics {name}: {o['ms']:.4f} ms, or_pull "
              f"{o['launches']} launches"
              + (f" ({float(np.median(pulls)):.4f} ms a launch)"
                 if pulls else "")
              + f", host reads {o['reads']}{extra}, bound {b_ms:.4f} ms "
              f"({b_by}), busy share "
              + (f"{busy / o['ms']:.4f}" if busy is not None
                 else "not measured") + f"; card {card}")
    nf_ms = ops["nf"]["ms"] / NF_BATCHES
    print(f"{label} analytics: exact vs the host copies (transforms, BFS, "
          f"NF of {NF_VS_HOST} sources, SumSweep's diameter, radius and "
          f"sweeps {ss} on the symmetrized {SUMSWEEP_NODES}-node web-like "
          f"graph, {g20.num_arcs()} arcs, and {ssd} on the directed "
          f"{SUMSWEEP_DIRECTED_NODES}-node one, {gdir.num_arcs()} arcs; "
          f"host path {ss_host_s:.1f} s) and vs propagate_plain "
          f"(NF, geometric), betweenness vs CPU tensors ({bc_cpu_s:.1f} s); "
          f"full exact NF projected from {NF_BATCHES} batches: "
          f"{-(-n // 64)} batches x {nf_ms:.2f} ms = "
          f"{-(-n // 64) * nf_ms / 1e3:.1f} s (projected, not run); "
          f"host reads {reads}")
    print(f"{label} analytics or_pull: n {n} m {m}, at most {blocks[0]} "
          f"blocks a launch ({blocks[1]} with per-bit counts), exact vs "
          f"plain (one level, and a 4-word propagation of "
          f"{prop_levels} levels with per-bit counts and distances); one "
          f"level {ms:.4f} ms on the device ({call_ms:.4f} ms a call by CUDA "
          f"events), bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.2f} ms, scatter_reduce(amax) over the unpacked bits "
          f"{library_ms:.4f} ms; a level alone at k words: "
          + ", ".join(f"k {k} {level_ms[k]:.4f} ms (bound "
                      f"{level_bound[k]:.4f})" for k in LEVEL_KS)
          + f"; a BFS of {bfs_levels} levels in one launch {bfs_ms:.4f} ms "
          f"({bfs_ms / bfs_levels:.4f} a level, bound {bfs_bound:.4f}); "
          f"{launches} launches on the path; card {card}")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "level_ms": {str(k): v for k, v in level_ms.items()},
            "level_bound_ms": {str(k): v for k, v in level_bound.items()},
            "bfs_launch_ms": bfs_ms, "bfs_levels": bfs_levels,
            "blocks": blocks}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import webgraph_tpu_torch  # noqa: F401  (fails outside the repo)
    from webgraph_tpu_torch.formats.bvgraph import BVGraph

    start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    card = phase_device()
    regs = timed(phase_build)
    k0 = timed(phase_k0)
    probe = timed(phase_k2_probe)
    probes = timed(phase_probes)
    loop_rows = timed(phase_loop_probes)
    form_rows = timed(phase_form_probes)
    with tempfile.TemporaryDirectory() as tmp:
        timed(phase_k1_small, tmp)
        t0 = time.perf_counter()
        bv = _cell(tmp, "weblike-cnr2000-size")
        print(f"synthetic graph: {time.perf_counter() - t0:.2f} s to make "
              f"and store")
        k1 = timed(phase_main, bv, "weblike-cnr2000-size", card, tmp)
        query = timed(phase_query, bv, "weblike-cnr2000-size", card,
                      k1["csr"], k1["scan"])
        pull = timed(phase_analytics, bv, "weblike-cnr2000-size", card,
                     k1["csr"])
        if os.path.exists(CNR2000 + ".graph"):
            phase_main(BVGraph.load(CNR2000), "cnr-2000", card, tmp)
        else:
            print(f"cnr-2000: skipped ({CNR2000}.graph not present)")
        timed(phase_k2_small, tmp)
        label = "weblike-cnr2000-size-maxref-inf"
        bv = _cell(tmp, label)
        k2 = timed(phase_k2_main, bv, label, card)
        timed(phase_query, bv, label, card, k2["csr"], k2["scan"])
        label = "deep-chain-config3-minint2"
        timed(phase_k2_main, _cell(tmp, label), label, card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "webgraph_tpu"))
    check(not leaked, f"the port imported JAX or webgraph_tpu: {leaked[:5]}")

    def row(name, source, replaces, r, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": r["launches"], **extra,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "registers": regs[name.replace("k0_pcodes", "k0_probe")]}

    # K0 is device code inlined into k1_parse and k2_parse, and the
    # compaction helper is inlined into k2_resolve: each runs in every
    # launch of theirs, and is timed on its own through its probe kernel
    # k2_resolve also resolves K1's copies: its numbers on the K1 cell
    # under "k1_route"; both kernels answer batched queries (the 1,024
    # batch on the K1 cell) under "query_route"
    k2p, k2r = k2["k2_parse"], k2["k2_resolve"]
    k1p = k1["k1_parse"]
    kernels = [
        row("k1_parse", "webgraph_tpu_torch/csrc/decode2.cu",
            "webgraph_tpu/pallas/decode2.py:617", k1p,
            query_route={**query["k1_parse"],
                         "replaces": "webgraph_tpu/pallas/query2.py:140"}),
        row("k0_pcodes", "webgraph_tpu_torch/csrc/pcodes.cuh",
            "webgraph_tpu/pallas/pcodes.py:107",
            {**k0, "launches": k1p["launches"] + k2p["launches"]},
            inlined_in=["k1_parse", "k2_parse"],
            gamma_route={**probes.pop("gamma"),
                         "source": "webgraph_tpu_torch/csrc/decode2.cu",
                         "kernel": "k0_probe",
                         "replaces": "scripts/pallas_probe.py:18"}),
        row("k2_parse", "webgraph_tpu_torch/csrc/decode.cu",
            "webgraph_tpu/pallas/decode.py:423", k2p,
            phases="_p1b_blocks :669, _p2_extras :799"),
        row("k2_resolve", "webgraph_tpu_torch/csrc/decode.cu",
            "webgraph_tpu/pallas/decode.py:423", k2r,
            phases="_p3_round :938",
            k1_route={**k1["k2_resolve"],
                      "replaces": "webgraph_tpu/pallas/decode2.py:617"},
            query_route={**query["k2_resolve"],
                         "replaces": "webgraph_tpu/pallas/query2.py:140"}),
        row("k2_compact_probe", "webgraph_tpu_torch/csrc/decode.cu",
            "scripts/pallas_compact_chip.py:60",
            {**probe, "launches": k2r["launches"]},
            inlined_in=["k2_resolve"]),
        {**row("or_pull", "webgraph_tpu_torch/csrc/propagate.cu",
               "webgraph_tpu/algo/device.py:118", pull,
               note="no pallas_call: takes the place of the XLA "
                    "segmented-OR scan _seg_or_scan and its callers; ms, "
                    "bound and plain: one level over one word",
               **{k: pull[k] for k in ("level_ms", "level_bound_ms",
                                       "bfs_launch_ms", "bfs_levels",
                                       "blocks")}),
         "library_ms": pull["library_ms"]},
    ]
    # the fragment probes: each run on the probe path of phase_probes
    for name, replaces in PROBE_REPLACES.items():
        r = probes[name]
        kernels.append({
            **row(name, "webgraph_tpu_torch/csrc/probes.cu", replaces, r,
                  **{k: r[k] for k in ("device_ms", "reps", "plain_reps",
                                       "runs", "modes_ms") if k in r}),
            "library_ms": r["library_ms"], "library_note": r["library_note"]})
    # the in-loop primitive probes: each run on the probe path of
    # phase_loop_probes
    for name in FORM_LOOP_KERNELS:  # bisect2's loops ran on the form probe path
        r, f = loop_rows[name], form_rows.pop(name)
        for key in ("ms", "plain_ms", "bound_ms", "device_ms_at_plain_reps"):
            r[key] = None if r[key] is None or f[key] is None else r[key] + f[key]
        for key in ("launches", "reps", "plain_reps"):
            r[key] += f[key]
        r["max_abs_err"] = max(r["max_abs_err"], f["max_abs_err"])
        r["runs"].update(f["runs"])
        r["bound_by"] = max(r["runs"].values(), key=lambda x: x["bound_ms"])["bound_by"]
    for name, replaces in LOOP_REPLACES.items():
        r = loop_rows[name]
        kernels.append({
            **row(name, "webgraph_tpu_torch/csrc/loops.cu", replaces, r,
                  **{k: r[k] for k in ("reps", "plain_reps",
                                       "device_ms_at_plain_reps", "runs")}),
            "library_ms": r["library_ms"], "library_note": r["library_note"]})
    # the single-shot forms and the streaming decoder's probes: each run on
    # the probe path of phase_form_probes
    for name, replaces in FORM_REPLACES.items():
        r = form_rows[name]
        src = "forms.cu" if name.startswith("probe_form") else "loops.cu"
        kernels.append({
            **row(name, f"webgraph_tpu_torch/csrc/{src}", replaces, r,
                  **{k: r[k] for k in ("reps", "plain_reps",
                                       "device_ms_at_plain_reps", "runs")}),
            "library_ms": r["library_ms"], "library_note": r["library_note"]})
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
