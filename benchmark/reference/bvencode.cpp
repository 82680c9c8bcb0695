// The benchmark's frozen BVGraph encoder: the greedy sequential encoder of
// the port's host codec (webgraph_tpu_torch/host/wgt_codec.cpp, itself the
// reference CompressionThread and diffComp, BVGraph.java:2049-2219 and
// :2436-2650), copied here without its decoder so that a change to the
// port's encoders cannot change the benchmark's inputs or its reference
// bytes.  MSB-first bit order; gamma/delta/zeta_k/unary/Golomb/nibble codes.
//
// Build: benchmark/reference/encoder.py runs g++ at first use into
// benchmark/build/.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

constexpr int GAMMA = 2, DELTA = 1, GOLOMB = 3, UNARY = 5, ZETA = 6, NIBBLE = 7;

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

}  // namespace

extern "C" {

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

int64_t bench_bvgraph_encode(const int64_t* offsets, const int32_t* succ, int64_t n,
                             int window, int maxref, int minint, int zetak,
                             int outd_c, int ref_c, int blk_c, int bcnt_c, int res_c, int off_c,
                             uint8_t** out_graph, int64_t* out_graph_bits,
                             uint8_t** out_off, int64_t* out_off_bits,
                             int64_t* stats /* 76 entries, zeroed by caller */) {
    Settings s{window, maxref, minint, zetak, outd_c, ref_c, blk_c, bcnt_c, res_c, off_c};
    BitWriter g, o;
    const int cbs = window + 1;
    std::vector<std::vector<int32_t>> win(cbs);
    std::vector<int64_t> winref(cbs, 0);
    int64_t last_offset = 0;
    for (int64_t x = 0; x < n; x++) {
        int64_t d = offsets[x + 1] - offsets[x];
        o.write(off_c, g.written - last_offset, zetak);
        last_offset = g.written;
        int64_t b0 = g.written;
        g.write(outd_c, d, zetak);
        stats[0] += g.written - b0;
        std::vector<int32_t>& mine = win[x % cbs];
        mine.assign(succ + offsets[x], succ + offsets[x + 1]);
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

void bench_free(void* p) { std::free(p); }

}  // extern "C"
