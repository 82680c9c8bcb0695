// Instantaneous-code writers for the Hopper encode kernels (encode.cu).
//
// The counterparts of the closed-form lengths and right-aligned bit
// patterns of webgraph_tpu/formats/bvgraph_jax_encode.py (_bitlen ..
// make_pat_fn, :53-211) and its zigzag _int2nat_u (:213), for the six
// codings of webgraph_tpu_torch.bits.codes: γ, δ, ζ_k, unary, Golomb
// (b = zeta_k) and nibble.  Values are 64-bit here (the JAX module's are
// uint32), so γ of 2^32 - 1 is right where uint32 arithmetic wraps.
//
// A code is its length and the pattern of its last min(len, 64) bits,
// right-aligned: every coding's leading bits past 64 are zeros (a long
// unary run, a large Golomb quotient), and BitWriter skips them without
// writing, as the JAX _emit writes only the 1-bits into a zero-filled
// buffer.
//
// The stream is MSB-first in 32-bit words: bit p of the stream is bit
// 31 - (p & 31) of word p >> 5 (the JAX module's '>u4' words).

#pragma once
#include <cstdint>

namespace wgt {
namespace enc {

// Coding ids of webgraph_tpu.bits.codes.
constexpr int DELTA = 1;
constexpr int GAMMA = 2;
constexpr int GOLOMB = 3;
constexpr int UNARY = 5;
constexpr int ZETA = 6;
constexpr int NIBBLE = 7;

struct Code {
  uint64_t pat;  // the code's last min(len, 64) bits, right-aligned
  int64_t len;   // its length in bits
};

// Significant bits of v (0 for 0).
__device__ __forceinline__ int bitlen(uint64_t v) { return 64 - __clzll(v); }

// Zigzag (reference Fast.int2nat).
__device__ __forceinline__ uint64_t int2nat(int64_t x) {
  return x >= 0 ? static_cast<uint64_t>(x) << 1
                : (static_cast<uint64_t>(-x) << 1) - 1;
}

__device__ __forceinline__ int64_t gamma_len(uint64_t v) {
  return 2 * (bitlen(v + 1) - 1) + 1;
}

__device__ __forceinline__ int64_t code_len(int coding, uint64_t v, int k) {
  switch (coding) {
    case GAMMA:
      return gamma_len(v);
    case DELTA: {
      const int h = bitlen(v + 1) - 1;
      return gamma_len(h) + h;
    }
    case ZETA: {
      const int hb = bitlen(v + 1) - 1, h = hb / k, hk = h * k;
      return h + 1 + (hk + k - 1) + (hb != hk);
    }
    case UNARY:
      return static_cast<int64_t>(v) + 1;
    case GOLOMB: {
      const uint64_t b = static_cast<uint64_t>(k);
      const int64_t q = static_cast<int64_t>(v / b);
      const int s = bitlen(b) - 1;
      if (b == (1ull << s)) return q + 1 + s;
      const uint64_t thr = (2ull << s) - b;
      return q + 1 + s + (v % b >= thr);
    }
    case NIBBLE: {
      const int nb = bitlen(v) > 1 ? bitlen(v) : 1;
      return 4 * ((nb + 2) / 3);
    }
    default:
      return -1;  // the wrapper admits the six codings only
  }
}

__device__ __forceinline__ Code code(int coding, uint64_t v, int k) {
  switch (coding) {
    case GAMMA: {
      const uint64_t z = v + 1;
      return {z, 2 * (bitlen(z) - 1) + 1};
    }
    case DELTA: {
      const uint64_t z = v + 1;
      const int h = bitlen(z) - 1;
      // γ(h) is h + 1 over gamma_len(h) bits, then the h low bits of z
      const uint64_t low = h > 0 ? z - (1ull << h) : 0;
      return {(static_cast<uint64_t>(h + 1) << h) | low, gamma_len(h) + h};
    }
    case ZETA: {
      const uint64_t z = v + 1;
      const int hb = bitlen(z) - 1, h = hb / k, hk = h * k;
      const uint64_t left = 1ull << hk;
      const uint64_t m = z - left;
      // minimal binary over [0, left (2^k - 1)): its threshold is left
      const bool is_long = hb != hk;
      const int mlen = hk + k - 1 + is_long;
      return {(1ull << mlen) | (is_long ? m + left : m), h + 1 + mlen};
    }
    case UNARY:
      return {1, static_cast<int64_t>(v) + 1};
    case GOLOMB: {
      const uint64_t b = static_cast<uint64_t>(k);
      const int64_t q = static_cast<int64_t>(v / b);
      const uint64_t r = v % b;
      const int s = bitlen(b) - 1;
      uint64_t mb = r;
      int mlen = s;
      if (b != (1ull << s)) {
        const uint64_t thr = (2ull << s) - b;
        if (r >= thr) {
          mb = r + thr;
          mlen = s + 1;
        }
      }
      return {(1ull << mlen) | mb, q + 1 + mlen};
    }
    case NIBBLE: {
      const int nb = bitlen(v) > 1 ? bitlen(v) : 1;
      const int g = (nb + 2) / 3;  // v < 2^48: at most 16 groups, 64 bits
      uint64_t pat = 0;
      for (int grp = g - 1; grp >= 0; grp--)  // most significant group first
        pat = (pat << 4) | (grp == 0 ? 8u : 0u) | ((v >> (3 * grp)) & 7u);
      return {pat, 4 * g};
    }
    default:
      return {0, -1};
  }
}

// Writes codes into the bit range [start, end) of a zero-filled stream of
// uint32 words, one word at a time.  The words that hold `start` and
// `end - 1` may hold bits of the neighbouring ranges, so they are written
// with atomicOr (the bits are disjoint, so the result does not depend on
// the order); the words between belong to this range alone and are
// stored plainly.  Words that stay zero are not written.
struct BitWriter {
  uint32_t* w;
  int64_t pos, wi, first, last;
  uint32_t cur;

  __device__ BitWriter(uint32_t* words, int64_t start, int64_t end)
      : w(words), pos(start), wi(start >> 5), first(start >> 5),
        last((end - 1) >> 5), cur(0) {}

  __device__ __forceinline__ void flush() {
    if (cur) {
      if (wi == first || wi == last)
        atomicOr(w + wi, cur);
      else
        w[wi] = cur;
    }
    cur = 0;
  }

  __device__ __forceinline__ void skip(int64_t bits) {
    const int64_t np = pos + bits;
    if ((np >> 5) != wi) {
      flush();
      wi = np >> 5;
    }
    pos = np;
  }

  __device__ __forceinline__ void put(Code c) {
    int64_t len = c.len;
    if (len > 64) {  // leading zeros
      skip(len - 64);
      len = 64;
    }
    while (len > 0) {
      const int room = 32 - static_cast<int>(pos & 31);
      const int take = len < room ? static_cast<int>(len) : room;
      const uint32_t bits =
          static_cast<uint32_t>((c.pat >> (len - take)) & ((1ull << take) - 1));
      cur |= bits << (room - take);
      pos += take;
      len -= take;
      if ((pos & 31) == 0) {
        flush();
        wi = pos >> 5;
      }
    }
  }

  __device__ __forceinline__ void done() { flush(); }
};

}  // namespace enc
}  // namespace wgt
