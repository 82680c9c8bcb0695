// wgt_codec — native host-side BVGraph codec of webgraph_tpu_torch (a copy
// of the JAX package's native/wgt_codec.cpp; the code below is unchanged).
//
// The card owns the data-parallel decode path; this library is the *host
// runtime* component: fast scalar encode/decode for ingestion, offset-index
// construction and oracle-speed round trips (the role the JVM codec plays in
// the reference framework). Bit conventions are identical to
// webgraph_tpu_torch.bits.bitstream (MSB-first; gamma/delta/zeta_k/unary/
// Golomb/nibble; BVGraph.java format docs at :121-291) and are verified
// byte-exactly against the Python oracle by the test suite.
//
// Build: webgraph_tpu_torch/native.py runs g++ at first use (never nvcc).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

constexpr int GAMMA = 2, DELTA = 1, GOLOMB = 3, UNARY = 5, ZETA = 6, NIBBLE = 7;

// ---------------------------------------------------------------- BitReader
struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos = 0;  // bit position

    explicit BitReader(const uint8_t* d, int64_t nb) : data(d), nbytes(nb) {}

    inline uint64_t peek64() const {
        // 64-bit window at bit `pos`, MSB-aligned (zero-padded past the end)
        int64_t byte = pos >> 3;
        int off = pos & 7;
        uint64_t hi = 0;
        if (byte + 8 <= nbytes) {
            std::memcpy(&hi, data + byte, 8);
            hi = __builtin_bswap64(hi);
        } else {
            for (int i = 0; i < 8; i++) hi = (hi << 8) | ((byte + i < nbytes) ? (uint64_t)data[byte + i] : 0);
        }
        if (off == 0) return hi;
        uint8_t nb_ = (byte + 8 < nbytes) ? data[byte + 8] : 0;
        return (hi << off) | ((uint64_t)nb_ >> (8 - off));
    }

    inline uint64_t read_bits(int width) {
        if (width == 0) return 0;
        uint64_t v = peek64() >> (64 - width);
        pos += width;
        return v;
    }
    inline int read_bit() { return (int)read_bits(1); }

    inline int64_t read_unary() {
        int64_t count = 0;
        for (;;) {
            uint64_t w = peek64();
            if (w) {
                int z = __builtin_clzll(w);
                pos += z + 1;
                return count + z;
            }
            count += 64;
            pos += 64;
        }
    }
    inline int64_t read_gamma() {
        uint64_t w = peek64();
        if (w) {
            int h = __builtin_clzll(w);
            if (2 * h + 1 <= 64) {
                pos += 2 * h + 1;
                return (int64_t)(w >> (63 - 2 * h)) - 1;
            }
        }
        int64_t h = read_unary();
        return (int64_t)(((uint64_t)1 << h) | read_bits((int)h)) - 1;
    }
    inline int64_t read_delta() {
        int64_t h = read_gamma();
        return (int64_t)(((uint64_t)1 << h) | read_bits((int)h)) - 1;
    }
    inline int64_t read_minimal_binary(int64_t b) {
        int s = 63 - __builtin_clzll((uint64_t)b);
        if (((int64_t)1 << s) == b) return (int64_t)read_bits(s);
        int64_t threshold = ((int64_t)1 << (s + 1)) - b;
        int64_t m = (int64_t)read_bits(s);
        if (m < threshold) return m;
        return ((m << 1) | read_bit()) - threshold;
    }
    inline int64_t read_zeta(int k) {
        int64_t h = read_unary();
        int64_t left = (int64_t)1 << (h * k);
        int width = (int)(h * k + k - 1);
        int64_t mv;
        if (width <= 64) mv = (int64_t)read_bits(width);
        else { int hiw = width - 64; mv = ((int64_t)read_bits(hiw) << 32) | (int64_t)read_bits(32); }
        if (mv < left) return mv + left - 1;
        return ((mv << 1) | read_bit()) - 1;
    }
    inline int64_t read_golomb(int b) {
        int64_t q = read_unary();
        return q * b + read_minimal_binary(b);
    }
    inline int64_t read_nibble() {
        int64_t x = 0;
        for (;;) {
            uint64_t g = read_bits(4);
            x = (x << 3) | (int64_t)(g & 7);
            if (g & 8) return x;
        }
    }
    inline int64_t read(int coding, int k) {
        switch (coding) {
            case GAMMA: return read_gamma();
            case DELTA: return read_delta();
            case UNARY: return read_unary();
            case ZETA: return read_zeta(k);
            case GOLOMB: return read_golomb(k);
            case NIBBLE: return read_nibble();
        }
        return -1;
    }
};

// ---------------------------------------------------------------- BitWriter
struct BitWriter {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int fill = 0;          // bits in acc
    int64_t written = 0;   // total bits

    inline void write_bits(uint64_t v, int width) {
        written += width;
        while (width > 0) {
            int take = std::min(width, 64 - fill);
            acc = (acc << take) | ((v >> (width - take)) & ((take == 64) ? ~0ULL : (((uint64_t)1 << take) - 1)));
            fill += take;
            width -= take;
            if (fill == 64) {
                uint64_t be = __builtin_bswap64(acc);
                const uint8_t* p = (const uint8_t*)&be;
                bytes.insert(bytes.end(), p, p + 8);
                acc = 0;
                fill = 0;
            }
        }
    }
    inline int64_t bit_length(int64_t) const { return written; }
    inline void write_unary(int64_t x) {
        while (x >= 63) { write_bits(0, 63); x -= 63; }
        write_bits(1, (int)x + 1);
    }
    static inline int msb(uint64_t v) { return 63 - __builtin_clzll(v); }
    inline void write_gamma(int64_t x) {
        uint64_t z = (uint64_t)x + 1;
        int h = msb(z);
        write_bits(z, 2 * h + 1);
    }
    inline void write_delta(int64_t x) {
        uint64_t z = (uint64_t)x + 1;
        int h = msb(z);
        write_gamma(h);
        write_bits(z - ((uint64_t)1 << h), h);
    }
    inline void write_minimal_binary(int64_t v, int64_t b) {
        int s = msb((uint64_t)b);
        if (((int64_t)1 << s) == b) { write_bits((uint64_t)v, s); return; }
        int64_t threshold = ((int64_t)1 << (s + 1)) - b;
        if (v < threshold) write_bits((uint64_t)v, s);
        else write_bits((uint64_t)(v + threshold), s + 1);
    }
    inline void write_zeta(int64_t x, int k) {
        uint64_t z = (uint64_t)x + 1;
        int h = msb(z) / k;
        write_unary(h);
        int64_t left = (int64_t)1 << (h * k);
        write_minimal_binary((int64_t)z - left, left * (((int64_t)1 << k) - 1));
    }
    inline void write_golomb(int64_t x, int b) {
        write_unary(x / b);
        write_minimal_binary(x % b, b);
    }
    inline void write_nibble(int64_t x) {
        int ng = 1;
        while ((x >> (3 * ng)) != 0) ng++;
        for (int i = ng - 1; i >= 0; i--) {
            uint64_t stop = (i == 0) ? 8 : 0;
            write_bits(stop | ((uint64_t)(x >> (3 * i)) & 7), 4);
        }
    }
    inline void write(int coding, int64_t x, int k) {
        switch (coding) {
            case GAMMA: write_gamma(x); return;
            case DELTA: write_delta(x); return;
            case UNARY: write_unary(x); return;
            case ZETA: write_zeta(x, k); return;
            case GOLOMB: write_golomb(x, k); return;
            case NIBBLE: write_nibble(x); return;
        }
    }
    uint8_t* finish(int64_t* out_bits) {
        if (fill > 0) {
            uint64_t rest = acc << (64 - fill);
            uint64_t be = __builtin_bswap64(rest);
            const uint8_t* p = (const uint8_t*)&be;
            int nb = (fill + 7) / 8;
            bytes.insert(bytes.end(), p, p + nb);
            acc = 0; fill = 0;
        }
        *out_bits = written;
        uint8_t* out = (uint8_t*)std::malloc(bytes.size());
        std::memcpy(out, bytes.data(), bytes.size());
        return out;
    }
};

struct Settings {
    int window, maxref, minint, zetak;
    int outd_c, ref_c, blk_c, bcnt_c, res_c, off_c;
};

// bit cost of a code without writing
inline int64_t code_len(int coding, int64_t x, int k) {
    switch (coding) {
        case GAMMA: { int h = BitWriter::msb((uint64_t)x + 1); return 2 * h + 1; }
        case DELTA: { int h = BitWriter::msb((uint64_t)x + 1); int hh = BitWriter::msb((uint64_t)h + 1); return 2 * hh + 1 + h; }
        case UNARY: return x + 1;
        case ZETA: {
            uint64_t z = (uint64_t)x + 1;
            int h = BitWriter::msb(z) / k;
            int64_t left = (int64_t)1 << (h * k);
            int64_t b = left * (((int64_t)1 << k) - 1);
            int s = BitWriter::msb((uint64_t)b);
            if (((int64_t)1 << s) == b) return h + 1 + s;
            int64_t threshold = ((int64_t)1 << (s + 1)) - b;
            return h + 1 + (((int64_t)z - left < threshold) ? s : s + 1);
        }
        case GOLOMB: {
            int64_t q = x / k;
            int64_t r = x % k;
            int s = BitWriter::msb((uint64_t)k);
            int64_t bb = k;
            int64_t threshold = ((int64_t)1 << (s + 1)) - bb;
            int extra = (((int64_t)1 << s) == bb) ? s : ((r < threshold) ? s : s + 1);
            return q + 1 + extra;
        }
        case NIBBLE: { int ng = 1; while ((x >> (3 * ng)) != 0) ng++; return 4 * ng; }
    }
    return 0;
}

inline int64_t int2nat(int64_t x) { return x >= 0 ? x << 1 : -((x << 1) + 1); }
inline int64_t nat2int(int64_t x) { return (x & 1) == 0 ? x >> 1 : -(x >> 1) - 1; }

}  // namespace

extern "C" {

// Decode `count` coded values, prefix-summed, into out[0..count).
int64_t wgt_decode_offsets(const uint8_t* data, int64_t nbytes, int64_t count,
                           int coding, int k, int64_t* out) {
    BitReader r(data, nbytes);
    int64_t acc = 0;
    for (int64_t i = 0; i < count; i++) {
        acc += r.read(coding, k);
        out[i] = acc;
    }
    return r.pos;
}

// Sequential decode of a BVGraph stream into CSR arrays.
// Returns number of arcs decoded, or -1 on inconsistency.
int64_t wgt_bvgraph_decode(const uint8_t* data, int64_t nbytes, int64_t n, int64_t m,
                           int window, int minint, int zetak,
                           int outd_c, int ref_c, int blk_c, int bcnt_c, int res_c,
                           int64_t* out_offsets, int32_t* out_succ) {
    BitReader r(data, nbytes);
    const int cbs = window + 1;
    std::vector<std::vector<int32_t>> win(cbs);
    std::vector<int64_t> blocks;
    std::vector<int32_t> merged, lefts, lens;
    int64_t arc = 0;
    out_offsets[0] = 0;
    for (int64_t x = 0; x < n; x++) {
        int64_t d = r.read(outd_c, zetak);
        std::vector<int32_t>& mine = win[x % cbs];
        mine.clear();
        if (d > 0) {
            int64_t ref = -1;
            if (window > 0) ref = r.read(ref_c, zetak);
            blocks.clear();
            int64_t copied = 0, total = 0, block_count = 0;
            if (ref > 0) {
                block_count = r.read(bcnt_c, zetak);
                for (int64_t i = 0; i < block_count; i++) {
                    int64_t b = r.read(blk_c, zetak) + (i == 0 ? 0 : 1);
                    blocks.push_back(b);
                    total += b;
                    if ((i & 1) == 0) copied += b;
                }
                const std::vector<int32_t>& refl = win[(x - ref) % cbs];
                if ((block_count & 1) == 0) copied += (int64_t)refl.size() - total;
            }
            int64_t extra = (ref > 0) ? d - copied : d;
            lefts.clear(); lens.clear();
            if (extra > 0 && minint != 0) {
                int64_t ic = r.read_gamma();
                if (ic) {
                    int64_t prev = x + nat2int(r.read_gamma());
                    int64_t ln = r.read_gamma() + minint;
                    lefts.push_back((int32_t)prev); lens.push_back((int32_t)ln);
                    prev += ln; extra -= ln;
                    for (int64_t i = 1; i < ic; i++) {
                        int64_t l = r.read_gamma() + prev + 1;
                        ln = r.read_gamma() + minint;
                        lefts.push_back((int32_t)l); lens.push_back((int32_t)ln);
                        prev = l + ln; extra -= ln;
                    }
                }
            }
            merged.clear();
            merged.reserve(d);
            // residuals
            std::vector<int32_t> res;
            if (extra > 0) {
                int64_t prev = x + nat2int(r.read(res_c, zetak));
                res.push_back((int32_t)prev);
                for (int64_t i = 1; i < extra; i++) {
                    prev += r.read(res_c, zetak) + 1;
                    res.push_back((int32_t)prev);
                }
            }
            // copies
            if (ref > 0) {
                const std::vector<int32_t>& refl = win[(x - ref) % cbs];
                size_t p = 0;
                bool copying = true;
                for (int64_t b : blocks) {
                    if (copying) for (int64_t i = 0; i < b && p < refl.size(); i++) merged.push_back(refl[p + i]);
                    p += b;
                    copying = !copying;
                }
                if (copying) for (; p < refl.size(); p++) merged.push_back(refl[p]);
            }
            // intervals
            for (size_t i = 0; i < lefts.size(); i++)
                for (int32_t v = lefts[i]; v < lefts[i] + lens[i]; v++) merged.push_back(v);
            // residuals
            merged.insert(merged.end(), res.begin(), res.end());
            std::sort(merged.begin(), merged.end());
            if ((int64_t)merged.size() != d) return -1;
            mine = merged;
            if (arc + d > m) return -1;
            std::memcpy(out_succ + arc, merged.data(), d * sizeof(int32_t));
            arc += d;
        }
        out_offsets[x + 1] = arc;
    }
    return arc;
}

// Greedy BVGraph encoder (reference CompressionThread semantics).
// stats layout: [bits_outd, bits_ref, bits_blocks, bits_intervals,
//               bits_residuals, copied_arcs, intervalised_arcs,
//               residual_arcs, tot_ref, tot_dist,
//               successor_gap_bins[33], residual_gap_bins[33]]  (76 total)
static inline void update_bins(int64_t node, const int32_t* lst, int64_t len, int64_t* bins) {
    if (len == 0) return;
    int64_t first = int2nat((int64_t)lst[0] - node);
    if (first > 0) bins[BitWriter::msb((uint64_t)first)]++;
    for (int64_t i = 1; i < len; i++) {
        int64_t gap = (int64_t)lst[i] - lst[i - 1];
        if (gap > 0) bins[BitWriter::msb((uint64_t)gap)]++;
    }
}
static int64_t diff_comp(BitWriter* w, const Settings& s, int64_t x, int64_t ref,
                         const int32_t* refl, int64_t reflen,
                         const int32_t* cur, int64_t curlen,
                         int64_t* stats) {
    if (ref == 0) reflen = 0;
    static thread_local std::vector<int64_t> blocks;
    static thread_local std::vector<int32_t> extras;
    blocks.clear(); extras.clear();
    int64_t j = 0, t = 0, cbl = 0, copied_here = 0;
    bool copying = true;
    while (j < curlen && t < reflen) {
        if (copying) {
            if (cur[j] > refl[t]) { blocks.push_back(cbl); copying = false; cbl = 0; }
            else if (cur[j] < refl[t]) extras.push_back(cur[j++]);
            else { j++; t++; cbl++; copied_here++; }
        } else {
            if (cur[j] < refl[t]) extras.push_back(cur[j++]);
            else if (cur[j] > refl[t]) { t++; cbl++; }
            else { blocks.push_back(cbl); copying = true; cbl = 0; }
        }
    }
    if (copying && t < reflen) blocks.push_back(cbl);
    while (j < curlen) extras.push_back(cur[j++]);

    int64_t written = 0;
    const bool real = (w != nullptr);
    auto emit = [&](int coding, int64_t v, int stat_idx) {
        int64_t bits;
        if (real) { int64_t b0 = w->written; w->write(coding, v, s.zetak); bits = w->written - b0; }
        else bits = code_len(coding, v, s.zetak);
        written += bits;
        if (real && stats) stats[stat_idx] += bits;
    };
    if (s.window > 0) emit(s.ref_c, ref, 1);
    if (ref != 0) {
        emit(s.bcnt_c, (int64_t)blocks.size(), 2);
        for (size_t i = 0; i < blocks.size(); i++) emit(s.blk_c, i == 0 ? blocks[i] : blocks[i] - 1, 2);
        if (real && stats) stats[5] += copied_here;
    }
    if (!extras.empty()) {
        static thread_local std::vector<int32_t> lefts, lens, residuals;
        lefts.clear(); lens.clear(); residuals.clear();
        const int32_t* res_ptr;
        int64_t res_cnt;
        if (s.minint != 0) {
            int64_t vl = (int64_t)extras.size();
            for (int64_t i = 0; i < vl; i++) {
                int64_t jj = 0;
                if (i < vl - 1 && extras[i] + 1 == extras[i + 1]) {
                    jj = 1;
                    while (i + jj < vl - 1 && extras[i + jj] + 1 == extras[i + jj + 1]) jj++;
                    jj++;
                    if (jj >= s.minint) {
                        lefts.push_back(extras[i]);
                        lens.push_back((int32_t)jj);
                        i += jj - 1;
                    }
                }
                if (jj < s.minint) residuals.push_back(extras[i]);
            }
            emit(GAMMA, (int64_t)lefts.size(), 3);
            int64_t prev = 0;
            for (size_t i = 0; i < lefts.size(); i++) {
                if (i == 0) emit(GAMMA, int2nat((int64_t)lefts[i] - x), 3);
                else emit(GAMMA, (int64_t)lefts[i] - prev - 1, 3);
                prev = lefts[i] + lens[i];
                if (real && stats) stats[6] += lens[i];
                emit(GAMMA, lens[i] - s.minint, 3);
            }
            res_ptr = residuals.data();
            res_cnt = (int64_t)residuals.size();
        } else {
            res_ptr = extras.data();
            res_cnt = (int64_t)extras.size();
        }
        if (res_cnt) {
            if (real && stats) { stats[7] += res_cnt; update_bins(x, res_ptr, res_cnt, stats + 43); }
            int64_t prev = res_ptr[0];
            emit(s.res_c, int2nat(prev - x), 4);
            for (int64_t i = 1; i < res_cnt; i++) {
                emit(s.res_c, (int64_t)res_ptr[i] - prev - 1, 4);
                prev = res_ptr[i];
            }
        }
    }
    return written;
}

int64_t wgt_bvgraph_encode_range(const int64_t* offsets, const int32_t* succ, int64_t n,
                                 int64_t first_node, int skip_first_offset,
                                 int window, int maxref, int minint, int zetak,
                                 int outd_c, int ref_c, int blk_c, int bcnt_c, int res_c, int off_c,
                                 uint8_t** out_graph, int64_t* out_graph_bits,
                                 uint8_t** out_off, int64_t* out_off_bits,
                                 int64_t* stats /* 10 entries, zeroed by caller */) {
    // Node-range shard encode: values are anchored to the GLOBAL node id
    // (first_node + i); the reference window starts fresh at the shard
    // boundary — exactly the reference's per-thread CompressionThread
    // semantics over splitNodeIterators ranges (BVGraph.java:2469-2487).
    // skip_first_offset: shards k >= 1 omit their leading offset delta (the
    // preceding shard's trailing delta plays that role after bit-concat).
    Settings s{window, maxref, minint, zetak, outd_c, ref_c, blk_c, bcnt_c, res_c, off_c};
    BitWriter g, o;
    const int cbs = window + 1;
    std::vector<std::vector<int32_t>> win(cbs);
    std::vector<int64_t> winref(cbs, 0);
    int64_t last_offset = 0;
    for (int64_t xi = 0; xi < n; xi++) {
        int64_t x = first_node + xi;
        int64_t d = offsets[xi + 1] - offsets[xi];
        if (xi > 0 || !skip_first_offset) o.write(off_c, g.written - last_offset, zetak);
        last_offset = g.written;
        int64_t b0 = g.written;
        g.write(outd_c, d, zetak);
        stats[0] += g.written - b0;
        std::vector<int32_t>& mine = win[x % cbs];
        mine.assign(succ + offsets[xi], succ + offsets[xi + 1]);
        if (d > 0) {
            update_bins(x, mine.data(), d, stats + 10);
            int64_t best_cost = INT64_MAX, best_cand = -1, best_ref = -1;
            winref[x % cbs] = -1;
            for (int64_t ref = 0; ref < cbs; ref++) {
                int64_t cand = ((x - ref) % cbs + cbs) % cbs;
                if (winref[cand] < maxref && !win[cand].empty()) {
                    int64_t cost = diff_comp(nullptr, s, x, ref, win[cand].data(), (int64_t)win[cand].size(),
                                             mine.data(), d, nullptr);
                    if (cost < best_cost) { best_cost = cost; best_cand = cand; best_ref = ref; }
                }
            }
            winref[x % cbs] = winref[best_cand] + 1;
            diff_comp(&g, s, x, best_ref, win[best_cand].data(), (int64_t)win[best_cand].size(),
                      mine.data(), d, stats);
            stats[8] += winref[x % cbs];
            stats[9] += best_ref;
        } else {
            winref[x % cbs] = 0;
        }
    }
    o.write(off_c, g.written - last_offset, zetak);
    *out_graph = g.finish(out_graph_bits);
    *out_off = o.finish(out_off_bits);
    return offsets[n];
}

int64_t wgt_bvgraph_encode(const int64_t* offsets, const int32_t* succ, int64_t n,
                           int window, int maxref, int minint, int zetak,
                           int outd_c, int ref_c, int blk_c, int bcnt_c, int res_c, int off_c,
                           uint8_t** out_graph, int64_t* out_graph_bits,
                           uint8_t** out_off, int64_t* out_off_bits,
                           int64_t* stats) {
    return wgt_bvgraph_encode_range(offsets, succ, n, 0, 0,
                                    window, maxref, minint, zetak,
                                    outd_c, ref_c, blk_c, bcnt_c, res_c, off_c,
                                    out_graph, out_graph_bits, out_off, out_off_bits, stats);
}

void wgt_free(void* p) { std::free(p); }

}  // extern "C"
