// K0: instantaneous-code readers for the Hopper decode kernels.
//
// Replaces the in-kernel readers of webgraph_tpu/pallas/pcodes.py (clz64,
// extract32, extract_wide, read_unary_short, read_gamma_u, read_delta_u,
// read_zeta_u, read_minimal_binary, nat2int_u, make_window_reader).  The TPU
// version holds a 64-bit MSB-first window as two uint32 vector registers;
// here it is one uint64_t register, shifted out of two big-endian stream
// words held in registers (BufReader, the record parse of K1 and K2), or
// rebuilt from two words at a bit cursor (window64: the probe, and K1's
// long-record tiles in shared memory).
//
// Every reader returns the decoded value and writes the code length.  A
// length above 64 marks a code that does not fit one window or whose value
// does not fit uint32 (a unary run of 64 bits or more, γ/δ/ζ codes of such
// values): the caller turns it into a per-lane error instead of decoding
// garbage.  Shifts by the full register width are undefined in C++, so the
// width-0 and full-width cases are explicit branches.

#pragma once
#include <cstdint>

namespace wgt {

// Coding ids of webgraph_tpu.bits.codes.
constexpr int DELTA = 1;
constexpr int GAMMA = 2;
constexpr int UNARY = 5;
constexpr int ZETA = 6;
constexpr int BAD_LEN = 65;

// Window of bits [pos, pos + 64) of a stream of big-endian uint64 words.
// The stream carries two zero words of padding past its last bit.
__device__ __forceinline__ uint64_t window64(const uint64_t* __restrict__ w,
                                             int64_t pos) {
  const int64_t i = pos >> 6;
  const int s = static_cast<int>(pos & 63);
  const uint64_t a = w[i];
  if (s == 0) return a;
  return (a << s) | (w[i + 1] >> (64 - s));
}

__device__ __forceinline__ int clz64(uint64_t x) { return __clzll(x); }

// Bits [start, start + width) of the window, width <= 32, start + width <= 64.
__device__ __forceinline__ uint32_t extract32(uint64_t x, int start, int width) {
  if (width <= 0) return 0u;
  return static_cast<uint32_t>((x << start) >> (64 - width));
}

// A field whose span may exceed 32 bits but whose value fits uint32 (its
// leading bits are zero in a valid stream).
__device__ __forceinline__ uint32_t extract_wide(uint64_t x, int start, int width) {
  const int excess = width > 32 ? width - 32 : 0;
  return extract32(x, start + excess, width - excess);
}

__device__ __forceinline__ uint32_t read_unary(uint64_t x, int& len) {
  const int z = clz64(x);
  len = z < 64 ? z + 1 : BAD_LEN;
  return static_cast<uint32_t>(z);
}

__device__ __forceinline__ uint32_t read_gamma(uint64_t x, int& len) {
  const int h = clz64(x);
  if (h > 31) { len = BAD_LEN; return 0u; }
  len = 2 * h + 1;
  return ((1u << h) | extract32(x, h + 1, h)) - 1u;
}

__device__ __forceinline__ uint32_t read_delta(uint64_t x, int& len) {
  int lg;
  const uint32_t h = read_gamma(x, lg);
  if (lg > 64 || h > 31u || lg + static_cast<int>(h) > 64) { len = BAD_LEN; return 0u; }
  len = lg + static_cast<int>(h);
  return ((1u << h) | extract32(x, lg, static_cast<int>(h))) - 1u;
}

__device__ __forceinline__ uint32_t read_zeta(uint64_t x, int k, int& len) {
  const int h = clz64(x);
  const int hk = h * k;
  const int lu = h + 1;
  const int s = hk + k - 1;
  // the long branch consumes one bit past the s-bit field
  if (h > 31 || hk > 31 || lu + s + 1 > 64) { len = BAD_LEN; return 0u; }
  const uint32_t m = extract_wide(x, lu, s);
  const uint32_t left = 1u << hk;
  if (m >= left) {
    len = lu + s + 1;
    return (m << 1) + extract32(x, lu + s, 1) - 1u;
  }
  len = lu + s;
  return m + left - 1u;
}

// Minimal binary code in the universe [0, b), b >= 1.
__device__ __forceinline__ uint32_t read_minimal_binary(uint64_t x, uint32_t b, int& len) {
  const int s = 31 - __clz(static_cast<int>(b));  // floor(log2 b)
  const uint32_t m = extract32(x, 0, s);
  const uint64_t threshold = (1ull << (s + 1)) - b;
  if (m >= threshold) {
    len = s + 1;
    return static_cast<uint32_t>(((static_cast<uint64_t>(m) << 1) | extract32(x, s, 1)) - threshold);
  }
  len = s;
  return m;
}

// Inverse zigzag: 0, 1, 2, 3, ... -> 0, -1, 1, -2, ...
__device__ __forceinline__ int64_t nat2int(uint32_t v) {
  const int64_t half = static_cast<int64_t>(v >> 1);
  return (v & 1u) ? -half - 1 : half;
}

// Dispatch on a coding id (make_window_reader).  GOLOMB and NIBBLE have no
// single-window reader; the host rejects them before launch.
__device__ __forceinline__ uint32_t read_code(uint64_t x, int coding, int k, int& len) {
  switch (coding) {
    case GAMMA: return read_gamma(x, len);
    case DELTA: return read_delta(x, len);
    case ZETA: return read_zeta(x, k, len);
    case UNARY: return read_unary(x, len);
    default: len = BAD_LEN; return 0u;
  }
}

// Per-thread error codes of the decode kernels (kernels/decode2.py and
// kernels/decode.py raise them).
constexpr int ERR_CODE = 1;   // a code does not fit the window / the stream
constexpr int ERR_REF = 3;    // a reference beyond the window
constexpr int ERR_COUNT = 4;  // the record's counts disagree

// The graph's codings: decode2.coding_key order.
struct Codings {
  int outd, ref, bcnt, blk, res, k, window, minint;
};

// Reads codes in stream order from a buffer in registers: the two stream
// words under the cursor, refilled one word at a time as the cursor crosses
// a word boundary.  A code costs a few shifts and at most one global load.
// Copying the struct saves the cursor.  An error is recorded once: a code
// that does not fit one window or runs past the stream (ERR_CODE).
struct BufReader {
  const uint64_t* w;
  int64_t nbits;
  int64_t i;      // index of word a
  uint64_t a, b;  // words i and i + 1
  int s;          // bits of a already consumed, 0..63
  int err;

  __device__ __forceinline__ void init(const uint64_t* words, int64_t n, int64_t pos) {
    w = words;
    nbits = n;
    err = 0;
    i = 0;
    s = 0;
    a = b = 0;
    if (pos < 0 || pos > n) { err = ERR_CODE; return; }
    i = pos >> 6;
    s = static_cast<int>(pos & 63);
    a = w[i];
    b = w[i + 1];
  }

  __device__ __forceinline__ int64_t read(int coding, int k) {
    if (err) return 0;
    const int64_t pos = (i << 6) + s;
    if (pos >= nbits) { err = ERR_CODE; return 0; }
    int len;
    const uint32_t v = read_code(s ? (a << s) | (b >> (64 - s)) : a, coding, k, len);
    if (len > 64 || pos + len > nbits) { err = ERR_CODE; return 0; }
    s += len;
    if (s >= 64) {
      s -= 64;
      ++i;
      a = b;
      b = w[i + 1];
    }
    return static_cast<int64_t>(v);
  }
};

}  // namespace wgt
