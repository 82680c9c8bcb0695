"""The steady-state cost model of the decoder: the counterpart of the JAX
package's ``scripts/pallas_composite_probe.py``, one kernel for each of its
five probes, each a serial chain of trips over one (8, 128) int32 tile of
1,024 lanes (lane l = 128 r + c), one block of 1,024 threads on the card:

* G ``probe_relayout`` (``:49``, called at ``:59``): ``TRIPS`` relayouts
  (8, 128) -> (1, 1024) -> (8, 128), +1 a trip, through shared memory;
* H ``probe_merge_trip`` (``:70``, ``:104``): the merge trip (the port's
  ``records.cuh::merge_serial``), the queue in shared memory;
* I ``probe_refill`` (``:117``, ``:147``): the word-queue refill
  (``BufReader``'s refill), from pages of P8 = 256 and 512 rows;
* J ``probe_compaction`` (``:158``, ``:199``): slab compaction into a pool
  of R = 128 and 288 rows (``warp_excl_scan``'s job in ``k2_resolve``);
* K ``probe_page_fetch`` (``:213``, ``:234``): a page-row fetch and
  transpose (``k2_resolve``'s reads of the parent's slots), P = 32.

Every input is drawn from one ``default_rng(11)`` in the script's order
(G, H, I256, I512, J128, J288, K32).  The plain versions follow the
script's steps, with gathers and ``index_add_`` in place of the one-hot
matrix products and ``torch.roll`` for ``pltpu.roll`` (whose direction is
``jnp.roll``'s in the reference's interpret mode).  Each run's checksum is
the script's, the wrapping int32 ``sum(out + 1)``.

    python -m webgraph_tpu_torch.probes.composite [--device cpu]

runs ``TRIPS`` trips on the card and ``CPU_TRIPS`` on the CPU, as the script
cuts its own ``TRIPS`` in interpret mode.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.kernels.pcodes import clz32
from webgraph_tpu_torch.probes import (check, device_ms, device_of, launch,
                                       parser, s32)

TRIPS = 1 << 17      # the script's on-chip trip count
CPU_TRIPS = 1 << 14  # and its interpret-mode one
TILE = (8, 128)
RUNS = ("G", "H", "I256", "I512", "J128", "J288", "K32")
SLAB = 128       # H's colbuf rows
# page rows the kernels stage in shared memory (csrc/probes.cu)
MAX_REFILL_PAGES = 1024
MAX_FETCH_PAGES = 64


def reps(run: str, trips: int) -> int:
    """The script's loop count of ``run`` at ``trips``."""
    return {"G": trips, "H": trips, "I": trips // 16,
            "J": max(trips // 256, 64), "K": max(trips // 64, 256)}[run[0]]


def inputs():
    """Every run's inputs, drawn as the script's ``main()`` draws them:
    ``{"G": (x,), "H": (x,), "I256": (pages, x), "I512": ...,
    "J128": (x, pre), "J288": ..., "K32": (pages, x)}``, int32 numpy."""
    rng = np.random.default_rng(11)

    def tile(lo, hi):
        return rng.integers(lo, hi, size=TILE).astype(np.int32)

    out = {"G": (tile(0, 99),), "H": (tile(1, 99),)}
    for p8 in (256, 512):
        pages = rng.integers(0, 99, size=(p8, 32)).astype(np.int32)
        out[f"I{p8}"] = (pages, tile(1, 99))
    for r in (128, 288):
        x = tile(1, 99)
        out[f"J{r}"] = (x, tile(0, r * 100))
    pages = rng.integers(0, 99, size=(32, 128)).astype(np.int32)
    out["K32"] = (pages, tile(1, 99))
    return out


def checksum(out) -> int:
    """The script's checksum of a run's (8, 128) output: the wrapping int32
    ``sum(out + 1)``."""
    return int(s32((out.long() + 1).sum()))


# ---------------------------------------------------------------------- G


def relayout_plain(x, trips: int):
    """Plain version of :func:`relayout`."""
    c = x.long()
    for _ in range(trips):
        c = s32(c.reshape(1, 1024).reshape(TILE) + 1)
    return c.to(torch.int32)


def relayout(x, trips: int):
    """G: ``x`` int32 (8, 128) -> ``x + trips``, a relayout round trip a
    trip.  CPU tensors take :func:`relayout_plain`; CUDA tensors launch
    ``probe_relayout``."""
    if x.device.type == "cpu":
        return relayout_plain(x, trips)
    check("relayout", "x", x, torch.int32, TILE, x.device)
    out = torch.empty(TILE, dtype=torch.int32, device=x.device)
    launch(relayout, "wgt_probe_relayout", x.device, x.data_ptr(), trips,
           out.data_ptr())
    return out


relayout.launches = 0


# ---------------------------------------------------------------------- H


def merge_trip_plain(x, trips: int):
    """Plain version of :func:`merge_trip`: the script's trip on int64
    tensors holding int32 values."""
    dev = x.device
    x = x.long()
    v, rv, iv = x, s32(x * 3), x % 7
    wq = x.reshape(1, 1024).repeat(8, 1)
    colbuf = torch.zeros((SLAB, 1024), dtype=torch.int64, device=dev)
    for t in range(trips):
        hi = v ^ (rv >> 3)
        lo = s32(v + iv)
        h = torch.where(hi > 0, clz32(hi & 0xFFFFFFFF), 32)
        rest = s32(((lo << (h & 31)) | (hi >> ((32 - h) & 31))) & 0xFFFFFFFF)
        val = s32((rest & 0xFFFF) + rv)
        take_c = val > rv
        take_i = ~take_c & (iv > 0)
        emit = torch.where(take_c, val, torch.where(take_i, iv, rv))
        rv = s32(torch.where(take_c, rv + 1, rv - 1))
        iv = s32(torch.where(take_i, iv - 1, iv + emit % 3))
        v = (v * 5 + emit) & 0x7FFFFFFF
        sel = (emit & 1).reshape(1, 1024) > 0
        wq = torch.where(sel, torch.roll(wq, 7, 0), wq)
        colbuf[t % SLAB] = emit.reshape(1024)
    out = s32(v + rv + iv + colbuf[0, :128].reshape(1, 128))
    return out.to(torch.int32), wq.to(torch.int32), colbuf.to(torch.int32)


def merge_trip(x, trips: int):
    """H: ``x`` int32 (8, 128) -> ``(out (8, 128), wq (8, 1024),
    colbuf (128, 1024))``, int32: the trips' result, the queue's first 8
    rows (the rows it shifts) and the emit slab (rows never written hold
    0).  CPU tensors take :func:`merge_trip_plain`; CUDA tensors launch
    ``probe_merge_trip``."""
    if x.device.type == "cpu":
        return merge_trip_plain(x, trips)
    dev = x.device
    check("merge_trip", "x", x, torch.int32, TILE, dev)
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    wq = torch.empty((8, 1024), dtype=torch.int32, device=dev)
    colbuf = torch.zeros((SLAB, 1024), dtype=torch.int32, device=dev)
    launch(merge_trip, "wgt_probe_merge_trip", dev, x.data_ptr(), trips,
           out.data_ptr(), wq.data_ptr(), colbuf.data_ptr())
    return out, wq, colbuf


merge_trip.launches = 0


# ---------------------------------------------------------------------- I


def refill_plain(pages, x, reps: int):
    """Plain version of :func:`refill`: the script's byte planes (a row
    gather in place of the one-hot product) and its 3-stage roll network."""
    p8 = pages.shape[0]
    planes = [pages[:, 8 * i:8 * (i + 1)].long() & 0xFF for i in range(4)]
    cur = x.long()
    for _ in range(reps):
        flat = cur.reshape(1024) % p8
        acc = sum(planes[i][flat].T << sh for i, sh in enumerate((0, 8, 16, 24)))
        sh = cur.reshape(1, 1024) & 7
        for b in range(3):
            acc = torch.where((sh >> b) & 1 > 0, torch.roll(acc, 8 - (1 << b), 0), acc)
        cur = (cur + acc[0].reshape(TILE)) & 0x7FFFFFFF
    return cur.to(torch.int32)


def refill(pages, x, reps: int):
    """I: ``pages`` int32 (P8, 32), P8 <= :data:`MAX_REFILL_PAGES`, ``x``
    int32 (8, 128) -> the cursors
    after ``reps`` refills, int32 (8, 128).  CPU tensors take
    :func:`refill_plain`; CUDA tensors launch ``probe_refill``."""
    if x.device.type == "cpu":
        return refill_plain(pages, x, reps)
    dev = x.device
    check("refill", "pages", pages, torch.int32, (pages.shape[0], 32), dev)
    check("refill", "x", x, torch.int32, TILE, dev)
    if not 1 <= pages.shape[0] <= MAX_REFILL_PAGES:
        raise ValueError(f"refill: 1 to {MAX_REFILL_PAGES} page rows")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    launch(refill, "wgt_probe_refill", dev, pages.data_ptr(), pages.shape[0],
           x.data_ptr(), reps, out.data_ptr())
    return out


refill.launches = 0


# ---------------------------------------------------------------------- J


def compaction_plain(x, pre, r: int, reps: int):
    """Plain version of :func:`compaction`: the script's slab, its 7-stage
    roll network and split, ``index_add_`` in place of the one-hot scatter
    products, each byte plane summed and masked to 8 bits."""
    dev = x.device
    colbuf = x.long().reshape(1, 1024).expand(128, 1024)
    carry = x.long()
    cols = torch.arange(128, device=dev)[None, :]
    pool = torch.zeros((r, 128), dtype=torch.int64, device=dev)
    for t in range(reps):
        a = s32(colbuf.T + carry[0, 0])
        p = s32(pre.long().reshape(1024) + t) % (r * 128 - 256)
        sh = (p & 127)[:, None]
        b = a
        for bit in range(7):
            b = torch.where((sh >> bit) & 1 > 0, torch.roll(b, 128 - (1 << bit), 1), b)
        top = cols >= sh
        b0 = torch.where(top, b, 0)
        b1 = torch.where(top, 0, b)
        r0 = p >> 7
        pool = torch.zeros((r, 128), dtype=torch.int64, device=dev)
        for shv in (0, 8, 16, 24):
            part = torch.zeros((r, 128), dtype=torch.int64, device=dev)
            part.index_add_(0, r0, (b0 >> shv) & 0xFF)
            part.index_add_(0, r0 + 1, (b1 >> shv) & 0xFF)
            pool = pool + ((part & 0xFF) << shv)
        pool = s32(pool)
        carry = s32(carry + pool[0:8, 0:128])
    return carry.to(torch.int32), pool.to(torch.int32)


def compaction(x, pre, r: int, reps: int):
    """J: ``x``, ``pre`` int32 (8, 128), a pool of ``r`` >= 8 rows ->
    ``(out (8, 128), pool (r, 128))``, int32, the pool of the last rep.
    CPU tensors take :func:`compaction_plain`; CUDA tensors launch
    ``probe_compaction``."""
    if x.device.type == "cpu":
        return compaction_plain(x, pre, r, reps)
    dev = x.device
    check("compaction", "x", x, torch.int32, TILE, dev)
    check("compaction", "pre", pre, torch.int32, TILE, dev)
    if r < 8:
        raise ValueError("compaction: the pool needs at least 8 rows")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    pool = torch.zeros((r, 128), dtype=torch.int32, device=dev)
    col_t = torch.empty((1024, 128), dtype=torch.int32, device=dev)
    launch(compaction, "wgt_probe_compaction", dev, x.data_ptr(), pre.data_ptr(),
           r, reps, col_t.data_ptr(), pool.data_ptr(), out.data_ptr())
    return out, pool


compaction.launches = 0


# ---------------------------------------------------------------------- K


def page_fetch_plain(pages, x, reps: int):
    """Plain version of :func:`page_fetch`: the script's byte-plane row
    fetch (a row gather in place of the one-hot product) and transpose."""
    np_ = pages.shape[0]
    pl = pages.long()
    carry = x.long()
    chk = torch.zeros(1024, dtype=torch.int64, device=x.device)
    for _ in range(reps):
        rows = pl[carry.reshape(1024) % np_]
        acc = sum(((rows >> sh) & 0xFF) << sh for sh in (0, 8, 16, 24))
        chk = chk + acc.reshape(32, 32, 4, 32).sum((1, 2)).reshape(1024)
        tr = acc.T
        carry = (carry + tr[0:1, :].reshape(TILE)) & 0x7FFFFFFF
    return carry.to(torch.int32), s32(chk).to(torch.int32)


def page_fetch(pages, x, reps: int):
    """K: ``pages`` int32 (P, 128), P <= :data:`MAX_FETCH_PAGES`, ``x`` int32 (8, 128) ->
    ``(out (8, 128), chk (1024,))``, int32: the cursors, and a checksum of
    every fetched word, ``chk[32 w + t]`` the wrapping sum over the reps of
    ``fetch[32 w + i, t + 32 q]`` for i < 32, q < 4.  CPU tensors take
    :func:`page_fetch_plain`; CUDA tensors launch ``probe_page_fetch``."""
    if x.device.type == "cpu":
        return page_fetch_plain(pages, x, reps)
    dev = x.device
    check("page_fetch", "pages", pages, torch.int32, (pages.shape[0], 128), dev)
    check("page_fetch", "x", x, torch.int32, TILE, dev)
    if not 1 <= pages.shape[0] <= MAX_FETCH_PAGES:
        raise ValueError(f"page_fetch: 1 to {MAX_FETCH_PAGES} page rows")
    out = torch.empty(TILE, dtype=torch.int32, device=dev)
    chk = torch.empty(1024, dtype=torch.int32, device=dev)
    launch(page_fetch, "wgt_probe_page_fetch", dev, pages.data_ptr(),
           pages.shape[0], x.data_ptr(), reps, out.data_ptr(), chk.data_ptr())
    return out, chk


page_fetch.launches = 0

KERNELS = {"G": relayout, "H": merge_trip, "I": refill, "J": compaction,
           "K": page_fetch}


def call(run: str, args, trips: int):
    """Run ``run`` (a name of :data:`RUNS`) on its inputs ``args`` (tensors
    on one device) at ``trips``: the kernel's whole output, a tuple whose
    first item is the (8, 128) result."""
    n = reps(run, trips)
    if run[0] == "J":
        out = compaction(*args, int(run[1:]), n)
    else:
        out = KERNELS[run[0]](*args, n)
    return out if isinstance(out, tuple) else (out,)


def run(device="cuda", trips: int = TRIPS):
    """Every run on the script's inputs on ``device``: ``{run: {"checksum",
    "out", "ms", "reps"}}``, ``ms`` the median CUDA-event time (None on
    the CPU)."""
    dev = device_of(device)
    res = {}
    for name, arrays in inputs().items():
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        out = call(name, args, trips)
        ms = device_ms(dev, lambda: call(name, args, trips))
        res[name] = {"checksum": checksum(out[0]), "out": out, "ms": ms,
                     "reps": reps(name, trips)}
    return res


def cost(name: str, ms, reps: int) -> str:
    """A run's time in the script's unit: ns a trip (G, H), ns a refill
    (I), µs a slab (J), µs a fetch (K)."""
    if ms is None:
        return "not timed (cpu)"
    if name[0] in "GHI":
        unit = "trip" if name[0] in "GH" else "refill"
        return f"{ms * 1e6 / reps:8.1f} ns/{unit}"
    if name[0] == "J":
        return f"{ms * 1e3 / reps:8.2f} us/slab ({ms * 1e6 / reps / 16384:6.2f} ns/slot)"
    return f"{ms * 1e3 / reps:8.2f} us/fetch"


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    trips = CPU_TRIPS if args.device == "cpu" else TRIPS
    print(f"device={args.device} TRIPS={trips}")
    for name, r in run(args.device, trips).items():
        print(f"{name:5s} {KERNELS[name[0]].__name__:11s}: "
              f"{cost(name, r['ms'], r['reps'])}  checksum {r['checksum']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
