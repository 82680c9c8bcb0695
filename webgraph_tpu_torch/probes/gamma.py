"""One γ read at each position: the counterpart of the JAX package's
``scripts/pallas_probe.py`` (``gamma_kernel`` ``:18``, called at ``:60``).

4,096 values below 2²⁰ (seed 0) are γ-coded into one stream; each lane
reads the code at its position and returns the value and the position
after it.  This is what K0's probe kernel ``k0_probe`` (``csrc/decode2.cu``,
wrapped by ``kernels/pcodes.probe``) computes, a code and its length at
each position, so the probe adds no kernel: :func:`gamma` converts the
stream to the port's uint64 words and calls it.

    python -m webgraph_tpu_torch.probes.gamma [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import OutputBitStream, bytes_to_words
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.probes import device_ms, device_of, parser, timed

N = 4096


def inputs():
    """The script's inputs: ``vals`` int64 (4096,) below 2**20 (seed 0),
    their γ stream's bytes, each code's position and the position after it,
    int32."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 20, size=N).astype(np.int64)
    obs = OutputBitStream()
    poss = []
    p = 0
    for v in vals:
        poss.append(p)
        p += obs.write(C.GAMMA, int(v), 3)
    return vals, obs.to_bytes(), np.asarray(poss, np.int32), \
        np.asarray(poss[1:] + [p], np.int32)


def stream_words(data: bytes):
    """The stream's bytes -> the port's words: big-endian uint64 in int64
    with two zero words of padding."""
    w = np.concatenate([bytes_to_words(data), np.zeros(2, np.uint64)])
    return w.view(np.int64)


def gamma(words, pos):
    """The γ code at each int32 position ``pos`` of ``words`` (the port's
    stream, :func:`stream_words`): ``(value int64, new position int32)``.
    Through ``kernels.pcodes.probe``: CPU tensors take its plain readers,
    CUDA tensors launch ``k0_probe``."""
    v, ln = P.probe(words, pos.long(), C.GAMMA)
    return v, pos + ln


def run(device="cuda"):
    """Read the script's codes on ``device`` and hold them to the values
    written and the positions after them: ``{"ok", "out", "newpos", "ms"}``,
    ``ms`` the median CUDA-event time of :func:`gamma` (None on the CPU)."""
    dev = device_of(device)
    vals, data, pos, ends = inputs()
    w = torch.from_numpy(stream_words(data)).to(dev)
    p = torch.from_numpy(pos).to(dev)
    out, newpos = gamma(w, p)
    ok = np.array_equal(out.cpu().numpy(), vals) and \
        np.array_equal(newpos.cpu().numpy(), ends)
    ms = device_ms(dev, lambda: gamma(w, p))
    return {"ok": ok, "out": out, "newpos": newpos, "ms": ms}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    r = run(args.device)
    print(f"gamma decode {'OK' if r['ok'] else 'BAD'}:",
          r["out"][:5].cpu().tolist(), f"device={args.device}")
    print(f"{N} codes: {timed(r['ms'])}")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
