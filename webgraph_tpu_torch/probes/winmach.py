"""Sequential code reads a lane: the counterpart of the JAX package's
``scripts/pallas_winmach_chip.py`` (its kernel at ``:47``, called at
``:108``).

1,024 lanes each decode ``K`` = 8 ζ₃ codes in sequence from their start
bit in one shared stream, against the values written (the script's
oracle).  The TPU probe ran K2's window machinery (a sliding word table,
refills, stalls); the port's fragment is ``wgt::BufReader``
(``csrc/pcodes.cuh``), the reader of both parses, one thread a lane, in
kernel ``probe_winmach`` (``csrc/probes.cu``).

    python -m webgraph_tpu_torch.probes.winmach [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import OutputBitStream
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.probes import (check, device_ms, device_of, launch,
                                       parser, s32, timed)

K = 8        # codes a lane
LANES = 1024
ZETA_K = 3   # the codes are ζ₃
WROWS = 32   # rows of 128 stream words


def inputs():
    """The script's inputs: ``vals`` int64 (1024, K) (seed 7, < 600), their
    ζ₃ stream as big-endian uint32 words in int32 (WROWS, 128), and each
    lane's start bit, int64 (1024,)."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 600, (LANES, K)).astype(np.int64)
    obs = OutputBitStream()
    starts = np.zeros(LANES, dtype=np.int64)
    for lane in range(LANES):
        starts[lane] = obs.written_bits
        for j in range(K):
            obs.write(C.ZETA, int(vals[lane, j]), ZETA_K)
    data = obs.to_bytes()
    pad = data + b"\x00" * ((-len(data)) % 4 + 8)
    w32 = np.frombuffer(pad, dtype=">u4").astype(np.uint32)
    words = np.zeros(WROWS * 128, dtype=np.uint32)
    words[: len(w32)] = w32[: len(words)]
    assert obs.written_bits <= (WROWS - 2) * 128 * 32, obs.written_bits
    return vals, words.view(np.int32).reshape(WROWS, 128), starts


def stream_words(words32):
    """Big-endian uint32 words (int32, any shape, an even count) -> the
    port's stream: big-endian uint64 words in int64 with two zero words of
    padding."""
    w = np.ascontiguousarray(words32).reshape(-1).view(np.uint32).astype(np.uint64)
    w64 = (w[0::2] << np.uint64(32)) | w[1::2]
    return np.concatenate([w64, np.zeros(2, np.uint64)]).view(np.int64)


def winmach_plain(words, starts, k: int = K):
    """Plain version of :func:`winmach`: the K0 readers at each lane's
    cursor, ``k`` times; -1 from a lane's first code that does not fit a
    window or the stream (``BufReader``'s error)."""
    nbits = (words.numel() - 2) * 64
    w32 = P.split_words(words)
    reader = P.make_window_reader(C.ZETA, ZETA_K)
    bad = (starts < 0) | (starts > nbits)
    pos = torch.where(bad, 0, starts)
    out = []
    for _ in range(k):
        bad = bad | (pos >= nbits)
        v, ln = reader(*P.window_at(w32, pos.clamp(max=nbits)))
        bad = bad | (ln > 64) | (pos + ln > nbits)
        out.append(torch.where(bad, -1, s32(v)))
        pos = torch.where(bad, pos, pos + ln)
    return torch.stack(out).to(torch.int32)


def winmach(words, starts, k: int = K):
    """Read ``k`` ζ₃ codes in sequence from each of ``starts`` (int64 bit
    positions) of ``words`` (int64 big-endian uint64 stream words, two zero
    words of padding).  Returns int32 (k, lanes), ``out[j, l]`` code j of
    lane l, -1 from a lane's first bad code.  CPU tensors take
    :func:`winmach_plain`; CUDA tensors launch ``probe_winmach``."""
    if words.device.type == "cpu":
        return winmach_plain(words, starts, k)
    dev = words.device
    check("winmach", "words", words, torch.int64, (words.numel(),), dev)
    check("winmach", "starts", starts, torch.int64, (starts.numel(),), dev)
    if words.numel() < 2:
        raise ValueError("winmach: the stream needs its two words of padding")
    out = torch.empty((k, starts.numel()), dtype=torch.int32, device=dev)
    if starts.numel() and k > 0:
        launch(winmach, "wgt_probe_winmach", dev, words.data_ptr(),
               (words.numel() - 2) * 64, starts.data_ptr(), starts.numel(), k,
               C.ZETA, ZETA_K, out.data_ptr())
    return out


winmach.launches = 0


def run(device="cuda"):
    """Decode the script's stream on ``device`` and hold it to the oracle:
    ``{"ok", "bad" (wrong codes), "out", "ms"}``, ``ms`` the kernel's
    median CUDA-event time on the card (None on the CPU)."""
    dev = device_of(device)
    vals, words, starts = inputs()
    w = torch.from_numpy(stream_words(words)).to(dev)
    st = torch.from_numpy(starts).to(dev)
    out = winmach(w, st)
    got = out.cpu().numpy().T.astype(np.int64)
    bad = int((got != vals).sum())
    ms = device_ms(dev, lambda: winmach(w, st))
    return {"ok": bad == 0, "bad": bad, "out": out, "ms": ms}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    r = run(args.device)
    print("window machinery:", "ok" if r["ok"] else "BAD")
    if not r["ok"]:
        print("num bad:", r["bad"])
    print(f"{LANES} lanes x {K} zeta_3 codes: {timed(r['ms'])}")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
