"""The in-loop primitive probes' kernel families, shared by the counterparts
of the JAX package's ``scripts/pallas_timing5.py``, ``pallas_bisect4.py``,
``pallas_bisect3.py`` and ``pallas_perf_probe.py`` (:mod:`.timing5`,
:mod:`.bisect4`, :mod:`.bisect3`, :mod:`.perf`).  Each TPU probe runs one
primitive in a ``fori_loop`` over an (8, 128) int32 carry of 1,024 lanes
(lane l = 128 r + c); each family here is one kernel of ``csrc/loops.cu``,
one block of 1,024 threads:

* :func:`lane_loop` (``probe_lane_loop``): the ``(v, rv)`` trip recurrence
  with the queue roll, slab row store and relayout of the merge trip; the
  VPU baseline; the row store;
* :func:`gather_loop` (``probe_gather_loop``): a whole ``take_along_axis``
  a trip (modes :data:`GL_ROWS`, :data:`GL_REPL`, :data:`GL_OWN`,
  :data:`GL_COL`);
* :func:`dot_loop` (``probe_dot_loop``): an int8 product a rep, prebaked
  (on the tensor cores) or against a one-hot matrix;
* :func:`plane_refill` (``probe_plane_refill``): the byte-plane word refill
  and the byte-plane row gather;
* :func:`transpose_loop` (``probe_transpose_loop``): a whole (T, 1024)
  transpose a rep (the carry's modes :data:`TL_MASK`, :data:`TL_ADDC`,
  :data:`TL_NOMASK`);
* :func:`copy_loop` (``probe_copy_loop``): an (8, 1024) slice copied into
  shared memory a rep (a TMA bulk copy on an mbarrier);
* :func:`stack_fetch` (``probe_stack_fetch``): a word of a lane's 128-row
  column stack;
* :func:`jframe` (``probe_jframe``): prefixes of the slab compaction;

(:mod:`.bisect2`'s two loops run on :func:`gather_loop` and
:func:`transpose_loop` too) and, for :mod:`.v6` and :mod:`.v6b` (``scripts/v6_probe.py``,
``v6_probe2.py``):

* :func:`v6_trip` (``probe_v6_trip``): the streaming decoder's trip, 8
  sub-steps of a queue row select, window shift, merge selects and append;
* :func:`v6_fetch` (``probe_v6_fetch``): one call of the one-hot stream
  fetch and the 32-chunk slab gather, summed;
* :func:`body_loop` (``probe_body_loop``): a fetch body's primitive a rep
  (:data:`BODIES`).

Each wrapper returns the script's (8, 128) output first, then what keeps
the kernel's work alive: a checksum of every element its TPU body computes
each rep (``chk``, the wrapping int32 sum a thread; :func:`dot_loop`'s
prebaked one a single word), or the buffers it fills.  CPU tensors take the
plain version, which keeps the script's steps (``torch.gather``,
``torch.roll``, the one-hot products as gathers or ``index_add_``); CUDA
tensors launch the kernel or raise.  Every count of reps is the wrapper's
keyword ``reps``.
"""

from __future__ import annotations

import dataclasses

import torch

from webgraph_tpu_torch.probes import (M32, check, device_ms, device_of, launch,
                                      parser, s32, tensors)

TILE = (8, 128)
SLAB = 128                # the trip probes' colbuf rows
UNWRITTEN = -(1 << 31)    # a slab row never written (interpret mode's fill)
STAGE_WORDS = 56 * 1024   # table words the kernels stage in shared memory
DOT_SMEM = 200 * 1024     # bytes of b probe_dot_loop stages
JR = 128                  # the compaction frame's pool rows
JMOD = JR * 128 - 256

# probe_lane_loop's flags (csrc/loops.cu)
LL_RESHAPE, LL_QUEUE_HALF, LL_QUEUE_ODD, LL_STORE_V = 1, 2, 4, 8
LL_STORE_T, LL_OUT_SLAB, LL_VPU, LL_ROWSTORE = 16, 32, 64, 128
# probe_gather_loop's modes
GL_ROWS, GL_REPL, GL_OWN, GL_COL = 0, 1, 2, 3
# probe_transpose_loop's carry modes (its addc)
TL_MASK, TL_ADDC, TL_NOMASK = 0, 1, 2
# probe_plane_refill's modes
PR_REFILL, PR_ROWS = 0, 1
# probe_jframe's stages: bisect4's j_frame variants, then bisect3's j_part parts
JF_STAGES = ("v0", "v1", "v2", "v3", "v4", "p0", "p1", "p2", "p3")
V6_QD, V6_U = 32, 8            # the v6 trip's queue rows and sub-steps
V6_GROUPS, V6_ROWS = 8, 384    # the v6 fetch's stream groups and rows a group
V6_SLAB = (1024, 4096)         # its slab (32 chunks of 128 words a row)
# probe_body_loop's bodies (v6_probe2's), and the stream's words a row
BODIES = ("A", "B", "C", "D", "D2", "E", "F")
LW = 1152


def _tile(dev, fill=0):
    return torch.full(TILE, fill, dtype=torch.int64, device=dev)


def _done(*ts):
    """int64 tensors holding int32 values (or wrapping sums) -> int32."""
    return tuple(s32(t).to(torch.int32) for t in ts)


# ---------------------------------------------------------------- lane loop


def lane_loop_plain(x, flags: int, rounds: int, reps: int, slab: int = SLAB):
    """Plain version of :func:`lane_loop`: the scripts' trip on int64
    tensors holding int32 values."""
    dev = x.device
    v = x.long()
    rv = s32(v * 3)
    wq = v.reshape(1, 1024).repeat(8, 1)
    colbuf = torch.full((slab, 1024), UNWRITTEN, dtype=torch.int64, device=dev)
    half = torch.arange(1024, device=dev)[None, :] < 512
    for t in range(reps):
        if flags & LL_VPU:
            for _ in range(rounds):
                v = (v * 3 + 1) & 0x7FFFFFFF
                v = v ^ (v >> 5)
                v = s32(v + t)
                v = torch.where(v > 100, s32(v - 7), v)
        elif flags & LL_ROWSTORE:
            colbuf[t % slab] = v.reshape(1024)
            v = s32(v + 1)
        else:
            for _ in range(rounds):
                v = (v * 5 + rv) & 0x7FFFFFFF
                v = v ^ (v >> 7)
                rv = torch.where(v > rv, rv + 1, rv)
                rv = s32(rv + (v & 3))
        if flags & LL_RESHAPE:
            v = s32(v + v.reshape(1, 1024).reshape(TILE))
        if flags & (LL_QUEUE_HALF | LL_QUEUE_ODD):
            if flags & LL_QUEUE_HALF:
                wq = torch.where(half, torch.roll(wq, 7, 0), wq)
            elif t & 1:
                wq = torch.roll(wq, 7, 0)
            v = s32(v + wq[0, :128].reshape(1, 128))
        if flags & LL_STORE_V:
            colbuf[t % slab] = v.reshape(1024)
        elif flags & LL_STORE_T:
            colbuf[t % slab] = t
    out = v if flags & (LL_VPU | LL_ROWSTORE) else v + rv
    if flags & LL_OUT_SLAB:
        out = out + colbuf[0, :128].reshape(1, 128)
    return _done(out, wq, colbuf)


def lane_loop(x, flags: int, rounds: int, reps: int, slab: int = SLAB):
    """``x`` int32 (8, 128) -> ``(out (8, 128), wq (8, 1024),
    colbuf (slab, 1024))``, int32: ``reps`` trips of ``rounds`` rounds of
    the recurrence (``(v, rv)``'s, or perf F's with :data:`LL_VPU`, or
    none and a row store of the carry with :data:`LL_ROWSTORE`) and the
    extras of ``flags``; the queue and the slab as they end (rows never
    written hold :data:`UNWRITTEN`).  CPU tensors take
    :func:`lane_loop_plain`; CUDA tensors launch ``probe_lane_loop``."""
    if x.device.type == "cpu":
        return lane_loop_plain(x, flags, rounds, reps, slab)
    dev = x.device
    check("lane_loop", "x", x, torch.int32, TILE, dev)
    if slab < 1 or rounds < 0:
        raise ValueError("lane_loop: slab >= 1 and rounds >= 0")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    wq = torch.empty((8, 1024), dtype=torch.int32, device=dev)
    colbuf = torch.full((slab, 1024), UNWRITTEN, dtype=torch.int32, device=dev)
    launch(lane_loop, "wgt_probe_lane_loop", dev, x.data_ptr(), flags, rounds,
           reps, slab, out.data_ptr(), wq.data_ptr(), colbuf.data_ptr())
    return out, wq, colbuf


lane_loop.launches = 0


# ---------------------------------------------------------------- gather loop


def gather_loop_plain(table, carry0, mode: int, reps: int):
    """Plain version of :func:`gather_loop`: the script's
    ``take_along_axis`` as ``torch.gather`` on the whole table."""
    dev = table.device
    rows, cols = table.shape
    tbl = table.long()
    carry = carry0.long()
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    base = torch.arange(cols, device=dev)[None, :].expand(rows, cols)
    if mode == GL_OWN:
        carry = carry.reshape(1024, 1)
    for _ in range(reps):
        if mode in (GL_ROWS, GL_COL):
            key = carry[:1, :128] + (base if mode == GL_ROWS else 0)
            vals = torch.gather(tbl, 1, torch.remainder(key, 128).expand(rows, 128))
            chk += vals.reshape(rows // 8, 8, 128).sum(0).reshape(1024)
            carry = (carry + vals[:8, :128]) & 0xFFFF
        elif mode == GL_REPL:
            vals = torch.gather(tbl, 1, torch.remainder(s32(base + carry[:, :1]), cols))
            chk += vals.reshape(8, cols // 128, 128).sum(1).reshape(1024)
            carry = (carry + vals[:, :128]) & 0x7FFFFFFF
        else:
            vals = torch.gather(tbl, 1, torch.remainder(s32(base + carry), cols))
            chk += vals.reshape(32, 32, cols // 32, 32).sum((1, 2)).reshape(1024)
            carry = (carry + vals[:, :1]) & 0x7FFFFFFF
    return _done(carry.reshape(TILE), chk)


def _gather_ok(rows, cols, mode):
    return {GL_ROWS: cols == 128 and rows % 8 == 0,
            GL_COL: cols == 128 and rows % 8 == 0,
            GL_REPL: rows == 8 and cols % 128 == 0,
            GL_OWN: rows == 1024 and cols % 32 == 0}.get(mode, False)


def gather_loop(table, carry0, mode: int, reps: int):
    """``table`` int32 (rows, cols), ``carry0`` int32 (8, 128) -> ``(out
    (8, 128), chk (1024,))``, int32: ``reps`` trips, each gathering the
    whole table along its rows: :data:`GL_ROWS` (timing5 / bisect3 G: (N,
    128), every row at ``(c + carry[0][c]) & 127``, the carry & 0xFFFF),
    :data:`GL_REPL` (perf A: (8, W), row r at ``(w + carry[r][0]) % W``),
    :data:`GL_OWN` (perf C: (1024, T), row n at ``(t + carry_n) % T``, lane
    n's carry from its row's word 0), :data:`GL_COL` (bisect2: as G at
    ``carry[0][c] % 128``, no ``+ c``).  ``chk[l]`` sums the words thread l
    gathered: G rows r, r + 8, ... of column c; A columns c, c + 128, ... of
    row r; C columns lane, lane + 32, ... of the warp's 32 rows (l = 32 w +
    lane).  The first :data:`STAGE_WORDS` words of the flat table live in
    shared memory, the rest in L2.  CPU tensors take
    :func:`gather_loop_plain`; CUDA tensors launch ``probe_gather_loop``."""
    if table.device.type == "cpu":
        return gather_loop_plain(table, carry0, mode, reps)
    dev = table.device
    rows, cols = table.shape
    check("gather_loop", "table", table, torch.int32, (rows, cols), dev)
    check("gather_loop", "carry0", carry0, torch.int32, TILE, dev)
    if not _gather_ok(rows, cols, mode):
        raise ValueError(f"gather_loop: mode {mode} does not take a "
                         f"({rows}, {cols}) table")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(gather_loop, "wgt_probe_gather_loop", dev, table.data_ptr(), rows,
           cols, mode, carry0.data_ptr(), reps, min(rows * cols, STAGE_WORDS),
           out.data_ptr(), chk.data_ptr())
    return out, chk


gather_loop.launches = 0


# ---------------------------------------------------------------- product loop


def dot_loop_plain(a, b, onehot: bool, reps: int):
    """Plain version of :func:`dot_loop`: the product each rep (in float64,
    exact for int8 operands; CUDA has no integer ``matmul``), the one-hot
    one as a row gather."""
    dev = b.device
    k = b.shape[0]
    bl = b.long()
    carry = _tile(dev, 1)
    if onehot:
        chk = torch.zeros(1024, dtype=torch.int64, device=dev)
        for _ in range(reps):
            out = bl[carry.reshape(1024) % k]  # (1024, n)
            chk += out.sum(1)
            carry = (carry + out[:8, :128]) & 0x7FFF
        return _done(carry, chk)
    ad, bd = a.double(), b.double()
    chk = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(reps):
        out = (ad @ bd).long()
        chk += ((out & M32) ^ t).sum()
        carry = (carry + out[:8, :128]) & 0x7FFF
    return _done(carry, chk.reshape(1))


def dot_loop(a, b, onehot: bool, reps: int):
    """``a`` int8 (m, k), ``b`` int8 (k, n), n >= 128 -> ``(out (8, 128),
    chk)``, int32: ``reps`` reps of ``carry = (carry + p[:8, :128]) &
    0x7FFF`` from ones.  Prebaked: ``p = a @ b`` (int32 sums) every rep, on
    the tensor cores (m % 16 == 0, k % 32 == 0, n % 32 == 0); ``chk`` (1,)
    the wrapping sum over the reps t of ``p ^ t``.  One-hot (``a`` unused):
    ``p[l] = b[carry_l % k]``, ``chk[l]`` (1024,) the sum of row l of p over
    the reps.  CPU tensors take :func:`dot_loop_plain`; CUDA tensors launch
    ``probe_dot_loop``."""
    if b.device.type == "cpu":
        return dot_loop_plain(a, b, onehot, reps)
    dev = b.device
    k, n = b.shape
    check("dot_loop", "a", a, torch.int8, tuple(a.shape), dev)
    check("dot_loop", "b", b, torch.int8, (k, n), dev)
    if a.dim() != 2:
        raise ValueError("dot_loop: a must be a matrix")
    m = a.shape[0]
    smem = k * n if onehot else n * (k + 16)
    if onehot:
        ok = n >= 128 and n % 4 == 0
    else:
        ok = (a.shape[1] == k and m >= 16 and m % 16 == 0 and k % 32 == 0
              and n >= 128 and n % 32 == 0)
    if not ok or smem > DOT_SMEM:
        raise ValueError(f"dot_loop: shapes {tuple(a.shape)} x {tuple(b.shape)} "
                         f"not taken (onehot={bool(onehot)})")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024 if onehot else 1, dtype=torch.int32, device=dev)
    launch(dot_loop, "wgt_probe_dot_loop", dev, a.data_ptr(), b.data_ptr(), m, k,
           n, int(bool(onehot)), reps, out.data_ptr(), chk.data_ptr())
    return out, chk


dot_loop.launches = 0


# ---------------------------------------------------------------- byte-plane refill


def plane_refill_plain(pages, carry0, mode: int, reps: int):
    """Plain version of :func:`plane_refill`: the scripts' byte planes, the
    one-hot products as row gathers."""
    dev = pages.device
    rows = pages.shape[0]
    pg = pages.long()
    cur = carry0.long()
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    shifts = (0, 8, 16, 24)
    if mode == PR_REFILL:
        planes = [pg[:, 8 * i:8 * (i + 1)] & 0xFF for i in range(4)]
        for _ in range(reps):
            flat = cur.reshape(1024) % rows
            acc = sum(planes[i][flat].T << sh for i, sh in enumerate(shifts))
            chk += acc.sum(0)
            cur = (cur + acc[0].reshape(TILE)) & 0x7FFFFFFF
        return _done(cur, chk)
    planes = [(pg >> sh) & 0xFF for sh in shifts]
    for _ in range(reps):
        flat = cur.reshape(1024)
        hit = ((flat >= 0) & (flat < rows))[:, None]
        at = torch.where(hit[:, 0], flat, 0)
        acc = sum(torch.where(hit, planes[i][at], 0) << sh
                  for i, sh in enumerate(shifts))  # (1024, 128)
        chk += acc.reshape(32, 32, 4, 32).sum((1, 2)).reshape(1024)
        cur = torch.remainder(s32(cur + acc[:, :1].reshape(TILE)), rows)
    return _done(cur, chk)


def plane_refill(pages, carry0, mode: int, reps: int):
    """``pages`` int32, ``carry0`` int32 (8, 128) -> ``(out (8, 128), chk
    (1024,))``, int32.  :data:`PR_REFILL` (bisect3 R): (P8, 32) pages; a
    refill reads the plane products of row ``cur % P8``, eight words whose
    byte i is the low byte of column 8 i + j; word 0 advances ``cur`` (&
    0x7FFFFFFF), ``chk`` sums all eight.  :data:`PR_ROWS` (perf B): a (R,
    128) table; lane l fetches row ``carry_l`` (zeros outside the table),
    ``carry = (carry + row[0]) % R``, ``chk`` sums the rows of the warp's
    lanes that thread l read (columns lane + 32 q).  CPU tensors take
    :func:`plane_refill_plain`; CUDA tensors launch ``probe_plane_refill``."""
    if pages.device.type == "cpu":
        return plane_refill_plain(pages, carry0, mode, reps)
    dev = pages.device
    rows = pages.shape[0]
    cols = 32 if mode == PR_REFILL else 128
    check("plane_refill", "pages", pages, torch.int32, (rows, cols), dev)
    check("plane_refill", "carry0", carry0, torch.int32, TILE, dev)
    if mode not in (PR_REFILL, PR_ROWS) or rows < 1 \
            or (mode == PR_REFILL and rows * 32 > STAGE_WORDS * 4):
        raise ValueError(f"plane_refill: mode {mode} does not take {rows} rows")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(plane_refill, "wgt_probe_plane_refill", dev, pages.data_ptr(), rows,
           mode, carry0.data_ptr(), reps, min(rows * 128, STAGE_WORDS),
           out.data_ptr(), chk.data_ptr())
    return out, chk


plane_refill.launches = 0


# ---------------------------------------------------------------- transpose loop


def transpose_loop_plain(x, addc: int, reps: int):
    """Plain version of :func:`transpose_loop`."""
    dev = x.device
    t_rows = x.shape[0]
    xl = x.long()
    carry = _tile(dev)
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    for t in range(reps):
        tr = xl.T
        if addc == TL_ADDC:
            tr = s32(tr + carry[:1, :1])
        chk += tr.reshape(32, 32, t_rows // 32, 32).sum((1, 2)).reshape(1024)
        if addc == TL_ADDC:
            carry = s32(carry + tr[:8, :128])
        else:
            carry = s32(carry + tr[:8, :128] + t)
            if addc == TL_MASK:
                carry = carry & 0x7FFF
    return _done(carry, chk)


def transpose_loop(x, addc: int, reps: int):
    """``x`` int32 (T, 1024), T >= 128, T % 32 == 0 -> ``(out (8, 128), chk
    (1024,))``, int32: ``reps`` reps of the whole transpose ``tr = x.T``
    (``+ carry[0][0]`` with :data:`TL_ADDC`) into a scratch; then, from
    zeros, ``carry = (carry + tr[:8, :128] + t) & 0x7FFF`` (:data:`TL_MASK`:
    timing5, bisect4), ``carry += tr[:8, :128]`` (:data:`TL_ADDC`: perf E)
    or ``carry + tr[:8, :128] + t`` (:data:`TL_NOMASK`: bisect2).
    ``chk[32 w + lane]`` sums ``tr[32 w + i][32 j + lane]`` over i, j and
    the reps.  CPU tensors take :func:`transpose_loop_plain`; CUDA tensors
    launch ``probe_transpose_loop``."""
    if x.device.type == "cpu":
        return transpose_loop_plain(x, addc, reps)
    dev = x.device
    t_rows = x.shape[0]
    check("transpose_loop", "x", x, torch.int32, (t_rows, 1024), dev)
    if t_rows < 128 or t_rows % 32:
        raise ValueError("transpose_loop: x needs a multiple of 32 rows, >= 128")
    if addc not in (TL_MASK, TL_ADDC, TL_NOMASK):
        raise ValueError(f"transpose_loop: no carry mode {addc}")
    xt = torch.empty((1024, t_rows), dtype=torch.int32, device=dev)
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(transpose_loop, "wgt_probe_transpose_loop", dev, x.data_ptr(), t_rows,
           int(addc), reps, xt.data_ptr(), out.data_ptr(), chk.data_ptr())
    return out, chk


transpose_loop.launches = 0


# ---------------------------------------------------------------- copy loop


def copy_loop_plain(x, reps: int):
    """Plain version of :func:`copy_loop`: a copy into the buffer a rep."""
    dev = x.device
    xl = x.long()
    buf = torch.zeros((8, 1024), dtype=torch.int64, device=dev)
    carry = _tile(dev)
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    for t in range(reps):
        buf.copy_(xl[(t % 32) * 8:(t % 32) * 8 + 8])
        chk += buf.sum(0)
        carry = (carry + buf[0:8, 0:128]) & 0x7FFF
    return _done(carry, chk)


def copy_loop(x, reps: int):
    """``x`` int32 (rows >= 256, 1024) -> ``(out (8, 128), chk (1024,))``,
    int32: each rep rows ``(t % 32) * 8 .. + 8`` of ``x`` copied into a
    buffer in shared memory (a TMA bulk copy completing on an mbarrier),
    ``carry = (carry + buf[0:8, 0:128]) & 0x7FFF`` from zeros, ``chk[l]``
    the sum of column l of every copied buffer.  CPU tensors take
    :func:`copy_loop_plain`; CUDA tensors launch ``probe_copy_loop``."""
    if x.device.type == "cpu":
        return copy_loop_plain(x, reps)
    dev = x.device
    rows = x.shape[0]
    check("copy_loop", "x", x, torch.int32, (rows, 1024), dev)
    if rows < 256:
        raise ValueError("copy_loop: x needs at least 256 rows")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(copy_loop, "wgt_probe_copy_loop", dev, x.data_ptr(), rows, reps,
           out.data_ptr(), chk.data_ptr())
    return out, chk


copy_loop.launches = 0


# ---------------------------------------------------------------- stack fetch


def stack_fetch_plain(x, reps: int):
    """Plain version of :func:`stack_fetch`: the script's 16-way select of a
    row group and its 3-stage roll network."""
    dev = x.device
    stack = torch.arange(128, device=dev)[:, None].expand(128, 1024)
    k = x.long() & 127
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    for _ in range(reps):
        kf = k.reshape(1, 1024)
        reg = kf >> 3
        acc = torch.zeros((8, 1024), dtype=torch.int64, device=dev)
        for r in range(16):
            acc = torch.where(reg == r, stack[8 * r:8 * (r + 1)], acc)
        sh = kf & 7
        for b in range(3):
            acc = torch.where((sh >> b) & 1 > 0, torch.roll(acc, 8 - (1 << b), 0), acc)
        chk += acc.sum(0)
        k = (k + (acc[0].reshape(TILE) & 3) + 1) & 127
    return _done(k, chk)


def stack_fetch(x, reps: int):
    """``x`` int32 (8, 128) -> ``(out (8, 128), chk (1024,))``, int32: from
    ``k = x & 127``, each rep the lane's word k of a (128, 1024) stack
    whose row k holds k, ``k = (k + (w & 3) + 1) & 127``; ``chk[l]`` sums
    the lane's selected group of 8 words.  CPU tensors take
    :func:`stack_fetch_plain`; CUDA tensors launch ``probe_stack_fetch``."""
    if x.device.type == "cpu":
        return stack_fetch_plain(x, reps)
    dev = x.device
    check("stack_fetch", "x", x, torch.int32, TILE, dev)
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(stack_fetch, "wgt_probe_stack_fetch", dev, x.data_ptr(), reps,
           out.data_ptr(), chk.data_ptr())
    return out, chk


stack_fetch.launches = 0


# ---------------------------------------------------------------- compaction frame


def jframe_plain(x, pre, stage: str, reps: int):
    """Plain version of :func:`jframe`: the scripts' slab transpose, 7-stage
    roll network, column mask and one-hot product (``index_add_`` of the
    sign-extended low bytes)."""
    dev = x.device
    s = JF_STAGES.index(stage)
    xl = x.long()
    carry = xl.clone()
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    pool = torch.zeros((JR, 128), dtype=torch.int64, device=dev)
    colbuf = xl.reshape(1, 1024).expand(128, 1024)
    cols = torch.arange(128, device=dev)[None, :]
    for t in range(reps):
        pre_t = torch.remainder(s32(pre.long().reshape(1024) + t), JMOD)
        if stage == "v0":
            out = xl
        elif stage == "v1":
            out = colbuf[0:8, 0:128]
        elif stage == "v4":
            out = pre_t.reshape(TILE)
        else:
            arr = colbuf.T
            if stage != "v2":
                arr = s32(arr + carry[:1, :1])
            if s >= JF_STAGES.index("p1"):
                sh = (pre_t & 127)[:, None]
                for b in range(7):
                    arr = torch.where((sh >> b) & 1 > 0,
                                      torch.roll(arr, 128 - (1 << b), 1), arr)
                if stage != "p1":
                    arr = torch.where(cols >= sh, arr, 0)
            chk += arr.sum(1)
            out = arr[:8, :128]
            if stage == "p3":
                p0 = arr & 0xFF
                p0 = torch.where(p0 >= 128, p0 - 256, p0)  # the int8 cast
                pool = torch.zeros((JR, 128), dtype=torch.int64, device=dev)
                pool.index_add_(0, pre_t >> 7, p0)
                out = pool[:8, :128]
        carry = s32(carry + out)
    return _done(carry, chk, pool)


def jframe(x, pre, stage: str, reps: int):
    """``x``, ``pre`` int32 (8, 128), a stage of :data:`JF_STAGES` ->
    ``(out (8, 128), chk (1024,), pool (128, 128))``, int32: ``reps`` reps
    of ``carry += out`` from ``x``, where out is the (8, 128) corner of the
    stage's array: ``v0`` x, ``v1`` the slab (``x`` broadcast to (128,
    1024)), ``v2`` its transpose A, ``v3`` and ``p0`` A + carry[0][0],
    ``v4`` ``(pre + t) % 16128``, ``p1`` A's rows rolled left by ``pre &
    127``, ``p2`` masked to columns >= ``pre & 127``, ``p3`` their low
    bytes, sign-extended, summed into pool row ``pre >> 7``.  ``chk[l]``
    sums lane l's row of the (1024, 128) array (stages v2, v3, p0-p3);
    ``pool`` is p3's last (zeros otherwise).  CPU tensors take
    :func:`jframe_plain`; CUDA tensors launch ``probe_jframe``."""
    if x.device.type == "cpu":
        return jframe_plain(x, pre, stage, reps)
    dev = x.device
    check("jframe", "x", x, torch.int32, TILE, dev)
    check("jframe", "pre", pre, torch.int32, TILE, dev)
    if stage not in JF_STAGES:
        raise ValueError(f"jframe: stage {stage!r} not in {JF_STAGES}")
    col_t = torch.empty((1024, 128), dtype=torch.int32, device=dev)
    pool = torch.zeros((JR, 128), dtype=torch.int32, device=dev)
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.zeros(1024, dtype=torch.int32, device=dev)
    launch(jframe, "wgt_probe_jframe", dev, x.data_ptr(), pre.data_ptr(),
           JF_STAGES.index(stage), reps, col_t.data_ptr(), pool.data_ptr(),
           out.data_ptr(), chk.data_ptr())
    return out, chk, pool


jframe.launches = 0


# ---------------------------------------------------------------- v6 trip


def _sel_row(rows, idx):
    """The scripts' ``sel_row``: ``rows[idx]`` a lane by a tree of selects
    on the bits of ``idx``."""
    level, bit = list(rows), 0
    while len(level) > 1:
        level = [torch.where(((idx >> bit) & 1) > 0, level[i + 1], level[i])
                 for i in range(0, len(level), 2)]
        bit += 1
    return level[0]


def v6_trip_plain(w, salt, reps: int):
    """Plain version of :func:`v6_trip`: the script's sub-steps on int64
    tensors (int32 values; the window words as uint32)."""
    dev = w.device
    q = [w[i].long() & M32 for i in range(V6_QD)]
    acc = _tile(dev) + salt.long().reshape(1, 1)
    cur, w0, w1, ap = _tile(dev), _tile(dev), _tile(dev), _tile(dev)
    ab = [_tile(dev) for _ in range(4)]
    for _ in range(reps):
        for u in range(V6_U):
            wv = _sel_row(q, cur & (V6_QD - 1))
            sh = cur & 31
            hi = ((w0 << sh) & M32) | torch.where(sh > 0, w1 >> (32 - sh), 0)
            v = hi >> 24
            ln = (v & 7) + 1
            if u % 2 == 0:
                w0, w1 = hi, w1 ^ wv
            eh, ih = acc & 255, cur & 255
            emit = torch.minimum(torch.minimum(v, eh), ih)
            cur = cur + torch.where((v <= eh) & (v <= ih), 1, 2)
            ab = [torch.where((ap & 3) == k, emit, ab[k]) for k in range(4)]
            ap = ap + 1
            acc = s32(acc + emit + ln)
    return _done(acc.sum().reshape(1, 1), torch.stack(ab + [w0, w1]))


def v6_trip(w, salt, reps: int):
    """``w`` int32 (32, 8, 128), the queue rows; ``salt`` int32 (1,) ->
    ``(out (1, 1), state (6, 8, 128))``, int32: ``reps`` trips of 8
    sub-steps a lane (the queue row ``cur & 31``, the window shift of ``(w0,
    w1)`` by ``cur & 31``, the merge's min and advance, the append to
    ``ab0-ab3``), acc from the salt; out the wrapping sum of acc, state
    ``ab0-ab3, w0, w1`` (the script never reads them).  CPU tensors take
    :func:`v6_trip_plain`; CUDA tensors launch ``probe_v6_trip``."""
    if w.device.type == "cpu":
        return v6_trip_plain(w, salt, reps)
    dev = w.device
    check("v6_trip", "w", w, torch.int32, (V6_QD,) + TILE, dev)
    check("v6_trip", "salt", salt, torch.int32, (1,), dev)
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    state = torch.empty((6,) + TILE, dtype=torch.int32, device=dev)
    launch(v6_trip, "wgt_probe_v6_trip", dev, w.data_ptr(), salt.data_ptr(), reps,
           out.data_ptr(), state.data_ptr())
    return out, state


v6_trip.launches = 0


# ---------------------------------------------------------------- v6 fetch


def _v6_call_plain(planes, r0, slab, idx, salt):
    """``int(sum(acc)) + sum(got) + salt`` of one call (int64, unwrapped)."""
    dev = slab.device
    acc = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    for g in range(V6_GROUPS):  # the one-hot product as a row gather
        rows = r0[g].long()
        ok = (rows >= 0) & (rows < V6_ROWS)
        acc = acc + torch.where(ok[:, None], planes[g].float()[torch.where(ok, rows, 0)], 0)
    ix = idx.long()
    got = torch.zeros_like(ix)
    for c in range(V6_SLAB[1] // 128):
        part = torch.gather(slab[:, c * 128:(c + 1) * 128].long(), 1, ix & 127)
        got = torch.where((ix >> 7) == c, part, got)
    return acc.double().sum().long() + got.sum() + salt


def v6_fetch_plain(planes, r0, slab, idx, salt, reps: int):
    """Plain version of :func:`v6_fetch`: the script's body a call, the
    one-hot products as row gathers and the 32-chunk select."""
    s = salt.long().reshape(())
    r = torch.stack([s32(_v6_call_plain(planes, r0, slab, idx, s + i))
                     for i in range(reps)])
    return _done(r.sum().reshape(1) + s, r)


def v6_fetch(planes, r0, slab, idx, salt, reps: int):
    """``planes`` bf16 (8, 384, 128), ``r0`` int32 (8, 128), ``slab`` int32
    (1024, 4096), ``idx`` int32 (1024, 128), ``salt`` int32 (1,) -> ``(total
    (1,), r (reps,))``, int32: ``reps`` calls of the script's kernel (one
    launch each, as ``fn200`` calls it), call i's ``r[i] =
    int(sum(acc)) + sum(got) + salt + i`` with ``acc[l][c]`` the sum over
    the 8 groups of ``planes[g][r0[g][l]][c]`` in float32 and ``got[n][j] =
    slab[n][idx[n][j]]`` (0 outside the slab row), ``sum(acc)`` in float64
    (exact where the TPU's float32 sum is); total the wrapping ``sum(r) +
    salt``.  CPU tensors take :func:`v6_fetch_plain`; CUDA tensors launch
    ``probe_v6_fetch``."""
    if slab.device.type == "cpu":
        return v6_fetch_plain(planes, r0, slab, idx, salt, reps)
    dev = slab.device
    check("v6_fetch", "planes", planes, torch.bfloat16, (V6_GROUPS, V6_ROWS, 128), dev)
    check("v6_fetch", "r0", r0, torch.int32, (V6_GROUPS, 128), dev)
    check("v6_fetch", "slab", slab, torch.int32, V6_SLAB, dev)
    check("v6_fetch", "idx", idx, torch.int32, (V6_SLAB[0], 128), dev)
    check("v6_fetch", "salt", salt, torch.int32, (1,), dev)
    r = torch.empty(reps, dtype=torch.int32, device=dev)
    for i in range(reps):
        launch(v6_fetch, "wgt_probe_v6_fetch", dev, planes.data_ptr(), r0.data_ptr(),
               slab.data_ptr(), idx.data_ptr(), salt.data_ptr(), i, r.data_ptr())
    return s32(r.long().sum().reshape(1) + salt.long()).to(torch.int32), r


v6_fetch.launches = 0


# ---------------------------------------------------------------- body loop


def body_loop_plain(x, salt, body: str, reps: int):
    """Plain version of :func:`body_loop`: the script's bodies (the 9-chunk
    select, the sublane gather, the 5-stage roll of place8, ``sel_row``)."""
    dev = x.device
    xl = x.long()
    acc = _tile(dev)
    chk = torch.zeros(1024, dtype=torch.int64, device=dev)
    cols = torch.arange(128, device=dev)[None, :]
    krow = torch.arange(32, device=dev)[:, None]
    for t in range(reps):
        i = s32(salt.long()[0, 0] + t)
        if body == "A":
            tr = (xl[:, :32] + i).T
            chk += tr.sum(0)
            acc = acc + tr[0:1, :].reshape(TILE)
        elif body in ("B", "C"):
            base = torch.remainder(s32(acc[0, 0] + i), LW - 128)
            idx = torch.clamp(base + cols, 0, LW - 1).expand(1024, 128)
            out = torch.zeros((1024, 128), dtype=torch.int64, device=dev)
            for c in range(LW // 128):
                g = torch.gather(xl[:, c * 128:(c + 1) * 128], 1,
                                 torch.clamp(idx - c * 128, 0, 127))
                out = torch.where((idx >> 7) == c, g, out)
            chk += out.reshape(32, 32, 4, 32).sum((1, 2)).reshape(1024)
            tr = out[:, :32].T
            acc = acc + tr[0:1].reshape(TILE)
            if body == "B":
                acc = acc + tr[31:32].reshape(TILE)
        elif body in ("D", "D2"):
            a = acc[0, 0] if body == "D" else acc.reshape(1, 1024)
            base = torch.remainder(s32(a * (1 if body == "D" else 7) + i), LW - 64)
            g = torch.gather(xl, 0, torch.clamp(krow + base, 0, LW - 1).expand(32, 1024))
            chk += g.sum(0)
            acc = acc + g[0:1].reshape(TILE) + g[31:32].reshape(TILE)
        elif body == "E":
            vals8 = xl[:, 0:8] + i
            pos = torch.remainder(s32(xl[:, 8:9] + i), 32)
            b = torch.cat([vals8, torch.zeros((1024, 248), dtype=torch.int64, device=dev)], 1)
            for j in range(5):
                b = torch.where(((pos >> j) & 1) > 0, torch.roll(b, 8 << j, 1), b)
            ci = torch.arange(256, device=dev)[None, :]
            r = torch.where((ci >= pos * 8) & (ci < pos * 8 + 8), b, 0)
            chk += r.sum(1)
            acc = acc + r[:, 0:1].T.reshape(TILE)
        else:
            regs = [xl[0:8, c:c + 128] + c for c in range(32)]
            sel = _sel_row(regs, (acc + i) & 31)
            chk += sel.reshape(1024)
            acc = acc + sel
        acc = s32(acc)
    return _done(acc, chk)


def body_loop(x, salt, body: str, reps: int):
    """``x`` int32, the stream (1024, 1152) or, for D and D2, its transpose;
    ``salt`` int32 (8, 128) -> ``(out (8, 128), chk (1024,))``, int32:
    ``reps`` reps of ``body`` (:data:`BODIES`, v6_probe2's) over the carry
    from zeros, rep t's ``i = t + salt[0][0]``: A ``carry += x[l][0] + i``
    (of the transpose of ``x[:, :32] + i``); B, C the 128-word window at
    ``(carry[0][0] + i) % 1024`` of every row, ``carry += w[l][0]`` (+
    ``w[l][31]``: B); D, D2 rows ``base + k``, k < 32, of ``x``, base
    ``(carry[0][0] + i) % 1088`` (D2: each lane's ``(carry_l * 7 + i) %
    1088``, ROADMAP C.12), ``carry += g[0][l] + g[31][l]``; E
    ``x[l][0:8] + i`` placed at column ``8 ((x[l][8] + i) % 32)`` of a
    256-word row, ``carry += row[0]``; F ``carry += x[r][c + k] + k``, ``k =
    (carry + i) & 31``.  ``chk[l]`` sums what thread l read of the words the
    body builds each rep (A the lane's 32 transposed words; B, C words lane
    + 32 p of its warp's 32 rows; D, D2 the lane's 32; E its 8 placed; F the
    selected one).  CPU tensors take :func:`body_loop_plain`; CUDA tensors
    launch ``probe_body_loop``."""
    if x.device.type == "cpu":
        return body_loop_plain(x, salt, body, reps)
    dev = x.device
    if body not in BODIES:
        raise ValueError(f"body_loop: body {body!r} not in {BODIES}")
    shape = (LW, 1024) if body in ("D", "D2") else (1024, LW)
    check("body_loop", "x", x, torch.int32, shape, dev)
    check("body_loop", "salt", salt, torch.int32, TILE, dev)
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(body_loop, "wgt_probe_body_loop", dev, x.data_ptr(), salt.data_ptr(),
           BODIES.index(body), reps, out.data_ptr(), chk.data_ptr())
    return out, chk


body_loop.launches = 0

KERNELS = {"probe_lane_loop": lane_loop, "probe_gather_loop": gather_loop,
           "probe_dot_loop": dot_loop, "probe_plane_refill": plane_refill,
           "probe_transpose_loop": transpose_loop, "probe_copy_loop": copy_loop,
           "probe_stack_fetch": stack_fetch, "probe_jframe": jframe}
# the kernels of v6_probe.py's and v6_probe2.py's loops
V6_KERNELS = {"probe_v6_trip": v6_trip, "probe_v6_fetch": v6_fetch,
              "probe_body_loop": body_loop}
PLAIN = {lane_loop: lane_loop_plain, gather_loop: gather_loop_plain,
         dot_loop: dot_loop_plain, plane_refill: plane_refill_plain,
         transpose_loop: transpose_loop_plain, copy_loop: copy_loop_plain,
         stack_fetch: stack_fetch_plain, jframe: jframe_plain,
         v6_trip: v6_trip_plain, v6_fetch: v6_fetch_plain, body_loop: body_loop_plain}


# ---------------------------------------------------------------- probes


@dataclasses.dataclass(frozen=True)
class Probe:
    """One run of a script: its name in the script's ``main()``, the
    wrapper it runs on, its numpy inputs (``casts``: a torch dtype an input
    is cast to, or None), the wrapper's other arguments, the script's loop
    count and what one loop is (for its cost)."""

    name: str
    kernel: object
    arrays: tuple
    params: dict
    reps: int
    unit: str
    casts: tuple = ()

    def tensors(self, dev):
        return tensors(self.arrays, self.casts, dev)

    def call(self, args, reps=None, plain=False):
        """The wrapper (or its plain version) on ``args`` (the inputs as
        tensors) at ``reps`` (the probe's own by default): a tuple whose
        first item is the (8, 128) output."""
        fn = PLAIN[self.kernel] if plain else self.kernel
        return fn(*args, **self.params, reps=self.reps if reps is None else reps)


def checksum(out) -> int:
    """The scripts' result of a run: the wrapping int32 ``sum(out + 1)`` of
    its (8, 128) output (the salt is 1)."""
    return int(s32((out.long() + 1).sum()))


def run_probes(probes, device="cuda", cut=None):
    """Each probe on ``device``: ``{name: {"out", "checksum", "ms", "reps",
    "unit", "kernel"}}``, ``ms`` its :func:`probes.device_ms` (None on the
    CPU).  ``cut`` maps a probe's name to its loop count; else each runs
    the script's."""
    dev = device_of(device)
    res = {}
    for p in probes:
        n = (cut or {}).get(p.name, p.reps)
        args = p.tensors(dev)
        out = p.call(args, n)
        ms = device_ms(dev, lambda: p.call(args, n))
        res[p.name] = {"out": out, "checksum": checksum(out[0]), "ms": ms,
                       "reps": n, "unit": p.unit,
                       "kernel": "probe_" + p.kernel.__name__}
    return res


def cost(r) -> str:
    """A run's time a loop, in the script's unit."""
    if r["ms"] is None:
        return "not timed (cpu)"
    per = r["ms"] * 1e6 / r["reps"]
    if per >= 1e4:
        return f"{per / 1e3:10.2f} us/{r['unit']}"
    return f"{per:10.1f} ns/{r['unit']}"


def main_for(module, argv=None):
    """The probes' command line for ``module`` (a script's counterpart):
    ``--device`` (default ``cuda``); each probe runs the script's loop
    count on the chip, or its interpret-mode one on the CPU."""
    args = parser(module.__doc__).parse_args(argv)
    cpu = args.device == "cpu"
    print(f"device={args.device} reps={'interpret' if cpu else 'chip'}")
    probes = module.probes(interpret=cpu)
    for name, r in run_probes(probes, args.device).items():
        print(f"{name:6s} {r['kernel']:21s} {r['reps']:8d} reps: {cost(r)}  "
              f"checksum {r['checksum']}")
    return 0
