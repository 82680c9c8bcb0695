"""Pool gathers, summed: the counterpart of the JAX package's
``scripts/pallas_fetch_bench.py`` (``make_kernel(mode)`` ``:31``, called at
``:91``).

Over ``K`` = 512 steps ``i``, 1,024 lanes and 16 columns ``c``, the wrapping
int32 sum of ``pool[p >> 7, ((p & 127) + c) & 127]``, ``p = pos + i``: the
gather of ``pool_fetch_queue`` that ``k2_resolve``'s parent-slot reads
stand for in the port.  The script times four ways of making the gather on
the MXU (``f32hi``, ``f32def``, ``int8``, ``bf16``); they are to compute
one value, so the port runs its one kernel, ``probe_fetch``
(``csrc/probes.cu``), under each mode's name and prints the script's four
lines.  (Two of the script's modes are wrong: ``f32def`` by its own
docstring for values past 11 bits on the TPU, and ``int8``, which ORs
sign-extended bytes into the word.)

    python -m webgraph_tpu_torch.probes.fetch [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.probes import (check, device_ms, device_of, launch,
                                       parser, s32)

LANES = 1024
ROWS = 152  # the cnr-2000 fetch size of the script
K = 512
MODES = ("f32hi", "f32def", "int8", "bf16")


def inputs():
    """The script's inputs: ``pos`` int32 (8, 128) in [0, 152 * 128 - 256)
    (seed 0) and ``pool`` int32 (152, 128) below 2**24 (seed 1)."""
    pos = np.random.default_rng(0).integers(
        0, ROWS * 128 - 256, (8, 128)).astype(np.int32)
    pool = np.random.default_rng(1).integers(
        0, 1 << 24, (ROWS, 128)).astype(np.int32)
    return pos, pool


def fetch_plain(pos, pool, k: int = K):
    """Plain version of :func:`fetch`: the script's steps, the one-hot row
    product as a row gather (a row outside the pool gives 0)."""
    p0 = pos.reshape(-1).long()
    pl = pool.long()
    cidx = torch.arange(128, device=pos.device)
    acc = torch.zeros((), dtype=torch.int64, device=pos.device)
    for i in range(k):
        p = s32(p0 + i)
        r0 = p >> 7
        ok = (r0 >= 0) & (r0 < pool.shape[0])
        x = torch.where(ok[:, None], pl[torch.where(ok, r0, 0)], 0)
        ga = torch.gather(x, 1, (cidx[None, :] + (p & 127)[:, None]) & 127)
        acc = s32(acc + ga[:, :16].sum())
    return acc.to(torch.int32).reshape(1, 1)


def fetch(pos, pool, k: int = K):
    """``pos`` int32 (8, 128), ``pool`` int32 (rows, 128) -> int32 (1, 1).
    CPU tensors take :func:`fetch_plain`; CUDA tensors launch
    ``probe_fetch``."""
    if pos.device.type == "cpu":
        return fetch_plain(pos, pool, k)
    dev = pos.device
    check("fetch", "pos", pos, torch.int32, (8, 128), dev)
    check("fetch", "pool", pool, torch.int32, (pool.shape[0], 128), dev)
    out = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    launch(fetch, "wgt_probe_fetch", dev, pos.data_ptr(), LANES,
           pool.data_ptr(), pool.shape[0], k, out.data_ptr())
    return out


fetch.launches = 0


def run(device="cuda", k: int = K):
    """The fetch on the script's inputs on ``device``, once a mode, held to
    :func:`fetch_plain`: ``{"ok", "value", "ms": {mode: ms}}``, ``ms`` the
    median CUDA-event time (None on the CPU)."""
    dev = device_of(device)
    pos, pool = inputs()
    p = torch.from_numpy(pos).to(dev)
    q = torch.from_numpy(pool).to(dev)
    want = int(fetch_plain(torch.from_numpy(pos), torch.from_numpy(pool), k))
    values, ms = {}, {}
    for mode in MODES:
        values[mode] = int(fetch(p, q, k))
        ms[mode] = device_ms(dev, lambda: fetch(p, q, k))
    return {"ok": all(v == want for v in values.values()), "value": want,
            "values": values, "ms": ms}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    r = run(args.device, K)
    for mode, v in r["values"].items():
        t = f"{r['ms'][mode] * 1e3 / K:.4f} us/fetch on the card" \
            if r["ms"][mode] is not None else "not timed (cpu)"
        print(f"{mode:7s}: {t}, sum {v}")
    print("fetch:", "ok" if r["ok"] else "BAD", f"(plain sum {r['value']})")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
