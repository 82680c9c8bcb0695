"""A table-row gather: the counterpart of the JAX package's
``scripts/pallas_onehot_probe.py`` (``gather_kernel`` ``:30``, called at
``:64``).

``out[i, j] = T[(idx[i, 0] >> 7) * 128 + (idx[i, j] & 127)]`` for a uint32
table ``T`` given as four int8 byte planes ``(R, 128)`` (bytes 3, 2, 1, 0 of
each word).  The table row of output row ``i`` comes from its column 0 only
(the TPU probe's one-hot row product), so this is ``T[idx]`` only where a
row's indices share one table row, as the script's do.  Kernel
``probe_row_gather`` (``csrc/probes.cu``): a block a row, the table row's
words staged in shared memory.

    python -m webgraph_tpu_torch.probes.onehot [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.probes import (check, device_ms, device_of, launch,
                                       parser, s32, timed)

W = 128 * 64  # words in the table
N = 256       # output rows


def inputs():
    """The script's inputs: the table ``words`` uint32 (8192,) (seed 0), its
    byte planes int8 (4, 64, 128) (bytes 3, 2, 1, 0) and ``idx`` int32
    (256, 128), each row's indices in one table row."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=W, dtype=np.uint64).astype(np.uint32)
    planes = np.stack([((words >> sh) & 0xFF).astype(np.int8).reshape(W // 128, 128)
                       for sh in (24, 16, 8, 0)])
    rows0 = rng.integers(0, W // 128, size=N)
    cols = rng.integers(0, 128, size=(N, 128))
    cols[:, 0] = rng.integers(0, 128, size=N)
    idx = (rows0[:, None] * 128 + cols).astype(np.int32)
    return words, planes, idx


def row_gather_plain(planes, idx):
    """Plain version of :func:`row_gather`."""
    rows = idx[:, 0].long() >> 7
    ok = (rows >= 0) & (rows < planes.shape[1])
    r = torch.where(ok, rows, 0)
    words = torch.zeros((idx.shape[0], 128), dtype=torch.int64, device=idx.device)
    for plane, sh in zip(planes, (24, 16, 8, 0)):
        words |= (plane[r].long() & 0xFF) << sh
    words = torch.where(ok[:, None], words, 0)
    return s32(torch.gather(words, 1, idx.long() & 127)).to(torch.int32)


def row_gather(planes, idx):
    """``planes`` int8 (4, R, 128), ``idx`` int32 (N, 128) -> int32
    (N, 128) holding the uint32 words (a table row outside the table gives
    0).  CPU tensors take :func:`row_gather_plain`; CUDA tensors launch
    ``probe_row_gather``."""
    if idx.device.type == "cpu":
        return row_gather_plain(planes, idx)
    dev = idx.device
    r = planes.shape[1] if planes.dim() == 3 else 0
    check("row_gather", "planes", planes, torch.int8, (4, r, 128), dev)
    check("row_gather", "idx", idx, torch.int32, (idx.shape[0], 128), dev)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.shape[0]:
        launch(row_gather, "wgt_probe_row_gather", dev, planes.data_ptr(), r,
               idx.data_ptr(), idx.shape[0], out.data_ptr())
    return out


row_gather.launches = 0


def run(device="cuda"):
    """Gather the script's indices on ``device`` and hold them to ``T[idx]``:
    ``{"ok", "out", "ms"}``, ``ms`` the median CUDA-event time of
    :func:`row_gather` (None on the CPU)."""
    dev = device_of(device)
    words, planes, idx = inputs()
    pl = torch.from_numpy(planes).to(dev)
    ix = torch.from_numpy(idx).to(dev)
    out = row_gather(pl, ix)
    ok = np.array_equal(out.cpu().numpy().view(np.uint32), words[idx])
    ms = device_ms(dev, lambda: row_gather(pl, ix))
    return {"ok": ok, "out": out, "ms": ms}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    r = run(args.device)
    print(f"row gather {'OK' if r['ok'] else 'BAD'} (device={args.device}): "
          f"{N * 128} words gathered {'exactly' if r['ok'] else 'WRONG'}")
    print(f"{N * 128} gathers a call: {timed(r['ms'])}")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
