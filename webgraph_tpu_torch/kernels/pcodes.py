"""Instantaneous-code readers (K0): plain PyTorch versions and the probe kernel.

Counterpart of ``webgraph_tpu/pallas/pcodes.py``.  Each plain reader is a
function of a 64-bit MSB-first bit window ``(hi, lo)``: two int64 tensors of
one shape holding uint32 values, bits [pos, pos + 64) of the stream.  It
returns ``(value, length)`` as int64 tensors, ``value`` in [0, 2**32).
Semantics are those of the scalar oracle ``webgraph_tpu_torch.bits.bitstream``.
A length above 64 marks a code that does not fit one window or whose value
does not fit uint32; the decoders turn it into an error.

On the card the readers are ``__device__`` functions in ``csrc/pcodes.cuh``,
inlined into the parse kernels (``k1_parse``, ``k2_parse``).
:func:`probe` runs them on their own through a small kernel, so that K0 is
checked against these plain versions and the oracle by itself.
"""

from __future__ import annotations

import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build

M32 = 0xFFFFFFFF
BAD_LEN = 65
# pseudo-coding of the probe kernel: minimal binary in per-position universes
MINIMAL_BINARY = -1


def clz32(x):
    """Leading zeros of uint32 values held in an int64 tensor (0..32)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))
        n = n + small * s
        x = torch.where(small, x << s, x)
    return n + (x == 0)


def clz64(hi, lo):
    """Leading zeros of the 64-bit window (0..64)."""
    return torch.where(hi > 0, clz32(hi), 32 + clz32(lo))


def extract32(hi, lo, start, width):
    """Bits [start, start + width) of the window (width <= 32,
    start + width <= 64; width 0 gives 0)."""
    start = torch.as_tensor(start, device=hi.device).expand_as(hi)
    width = torch.as_tensor(width, device=hi.device).expand_as(hi)
    r = torch.where(
        start >= 32,
        (lo << ((start - 32) & 31)) & M32,
        torch.where(start > 0,
                    ((hi << (start & 31)) | (lo >> ((32 - start) & 31))) & M32,
                    hi))
    v = torch.where(width > 0, r >> ((32 - width) & 31), torch.zeros_like(r))
    return torch.where(width >= 32, r, v)


def extract_wide(hi, lo, start, width):
    """A field whose span may exceed 32 bits but whose value fits uint32."""
    excess = (width - 32).clamp(min=0)
    return extract32(hi, lo, start + excess, width - excess)


def read_unary_short(hi, lo):
    """Unary runs shorter than 64 bits."""
    z = clz64(hi, lo)
    return z, torch.where(z < 64, z + 1, BAD_LEN)


def read_gamma_u(hi, lo):
    h = clz64(hi, lo)
    rest = extract32(hi, lo, h + 1, h)
    v = (((1 << (h & 31)) | rest) - 1) & M32
    return v, torch.where(h < 32, 2 * h + 1, BAD_LEN)


def read_delta_u(hi, lo):
    hg, lg = read_gamma_u(hi, lo)
    rest = extract32(hi, lo, lg, hg)
    v = (((1 << (hg & 31)) | rest) - 1) & M32
    ok = (lg <= 64) & (hg < 32) & (lg + hg <= 64)
    return v, torch.where(ok, lg + hg, BAD_LEN)


def read_zeta_u(hi, lo, k: int):
    h = clz64(hi, lo)
    lu = h + 1
    s = h * k + (k - 1)
    m = extract_wide(hi, lo, lu, s)
    left = 1 << ((h * k) & 31)
    is_long = m >= left
    extra = extract_wide(hi, lo, lu + s, torch.ones_like(s))
    # the extra bit is only consumed on the long branch
    v = torch.where(is_long, ((m << 1) + extra - 1) & M32,
                    (m + left - 1) & M32)
    ok = (h < 32) & (h * k < 32) & (lu + s + 1 <= 64)
    return v, torch.where(ok, lu + s + is_long, BAD_LEN)


def read_minimal_binary(hi, lo, b):
    """Minimal binary code in per-element universes ``b`` (>= 1)."""
    s = 31 - clz32(b)  # floor(log2 b)
    m = extract32(hi, lo, torch.zeros_like(s), s)
    threshold = (1 << (s + 1)) - b
    is_long = m >= threshold
    extra = extract32(hi, lo, s, torch.ones_like(s))
    v = torch.where(is_long, ((m << 1) | extra) - threshold, m)
    return v, s + is_long


def nat2int_u(v):
    """Inverse zigzag of uint32 values: 0, 1, 2, 3, ... -> 0, -1, 1, -2, ..."""
    half = v >> 1
    return torch.where((v & 1) == 0, half, -half - 1)


def make_window_reader(coding: int, k: int):
    """``f(hi, lo) -> (value, length)`` for one coding.  GOLOMB and NIBBLE
    have no single-window reader and raise."""
    if coding == C.GAMMA:
        return read_gamma_u
    if coding == C.DELTA:
        return read_delta_u
    if coding == C.ZETA:
        return lambda hi, lo: read_zeta_u(hi, lo, k)
    if coding == C.UNARY:
        return read_unary_short
    raise ValueError(f"no window reader for coding {coding}")


def split_words(words):
    """uint64 stream words (bit patterns in int64) -> uint32 halves in int64,
    MSB half first."""
    return torch.stack([(words >> 32) & M32, words & M32], 1).reshape(-1)


def window_at(w32, pos):
    """The window ``(hi, lo)`` at int64 bit positions ``pos`` of a stream of
    uint32 words held in int64 (padded with at least three zero words)."""
    i = pos >> 5
    off = pos & 31
    a, b, c = w32[i], w32[i + 1], w32[i + 2]
    sh = (32 - off) & 31
    hi = torch.where(off > 0, ((a << off) | (b >> sh)) & M32, a)
    lo = torch.where(off > 0, ((b << off) | (c >> sh)) & M32, b)
    return hi, lo


def probe_plain(words, pos, coding: int, k: int = 0, b=None):
    """Plain version of :func:`probe`."""
    hi, lo = window_at(split_words(words), pos)
    if coding == MINIMAL_BINARY:
        return read_minimal_binary(hi, lo, b)
    return make_window_reader(coding, k)(hi, lo)


def probe(words, pos, coding: int, k: int = 0, b=None):
    """Read one code at each bit position ``pos`` of the stream ``words``.

    ``words``: int64 tensor of big-endian uint64 stream words, padded with
    two zero words; ``pos``: int64 bit positions; ``coding``: a
    ``webgraph_tpu_torch.bits.codes`` id of a coding with a window reader, or
    :data:`MINIMAL_BINARY` with universes ``b`` (int64).  Returns
    ``(value, length)``, int64 and int32.

    CPU tensors take the plain readers; CUDA tensors launch the K0 probe
    kernel of ``csrc/decode2.cu``.
    """
    if words.device.type == "cpu":
        v, ln = probe_plain(words, pos, coding, k, b)
        return v, ln.to(torch.int32)
    if coding != MINIMAL_BINARY:
        make_window_reader(coding, k)  # rejects GOLOMB / NIBBLE
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"probe: unsupported device {dev}")
    if coding == MINIMAL_BINARY and b is None:
        raise ValueError("probe: minimal binary needs universes b")
    for name, t in (("words", words), ("pos", pos), ("b", b)):
        if t is not None and (t.device != dev or t.dtype != torch.int64
                              or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"probe: {name} must be a contiguous 1-d int64 "
                             f"tensor on {dev}")
    if b is not None and b.numel() != pos.numel():
        raise ValueError("probe: b and pos differ in length")
    n = pos.numel()
    val = torch.empty(n, dtype=torch.int64, device=dev)
    ln = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return val, ln
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wgt_k0_probe(
            words.data_ptr(), (words.numel() - 2) * 64, pos.data_ptr(),
            None if b is None else b.data_ptr(), n, coding, k,
            val.data_ptr(), ln.data_ptr(), stream)
    _build.check_launch("wgt_k0_probe", rc)
    probe.launches += 1
    return val, ln


probe.launches = 0
