// patolette_tpu native oracle library.
//
// Serial C++ implementations with the exact semantics of the reference's
// serial subsystems, used as golden oracles for the device programs and as
// host-side fallbacks. Written from the documented semantics
// (/root/reference/lib/src/dither/riemersma.c traversal + queue rules,
// /root/reference/src/patolette/patolette.pyx raster scans) — not a copy;
// data layout, state handling and structure are our own.
//
// Build: compiled at first use by native/__init__.py (liboracle-<hash>.so).
// ABI: plain C, consumed via ctypes (native/__init__.py).

#include <cstddef>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>
#include <thread>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

// Build-time source fingerprint (injected by the loader from
// sha256(oracle.cpp)); the ctypes loader checks it against the source on
// disk, so a stale library can never be silently used.
#ifndef ORACLE_SOURCE_HASH
#define ORACLE_SOURCE_HASH "unknown"
#endif

extern "C" const char* oracle_source_hash() { return ORACLE_SOURCE_HASH; }

namespace {

// ---------------------------------------------------------------------------
// Brute-force nearest neighbour (replaces FLANN kd-tree semantics: exact,
// lowest index wins ties).
// ---------------------------------------------------------------------------
inline int nearest(const double* q, const double* pal, int k) {
    int best = 0;
    double best_d = 1e300;
    for (int i = 0; i < k; i++) {
        const double dx = q[0] - pal[3 * i];
        const double dy = q[1] - pal[3 * i + 1];
        const double dz = q[2] - pal[3 * i + 2];
        const double d = dx * dx + dy * dy + dz * dz;
        if (d < best_d) { best_d = d; best = i; }
    }
    return best;
}

// ---------------------------------------------------------------------------
// Riemersma dither state
// ---------------------------------------------------------------------------
struct DitherState {
    long x = 0, y = 0;
    long width = 0, height = 0;
    int k = 0;
    const double* image = nullptr;   // (h*w, 3) row-major linear Rec2020
    const double* palette = nullptr; // (k, 3)
    std::vector<double> pal_scaled;  // luminance-weighted palette
    int32_t* out = nullptr;
    double queue[16][3];
    double qweights[16];
    double cw[3];                    // channel weights
};

void dither_pixel(DitherState& st) {
    double err[3] = {0, 0, 0};
    for (int i = 0; i < 16; i++)
        for (int c = 0; c < 3; c++)
            err[c] += st.queue[i][c] * st.qweights[i];

    const size_t idx = (size_t)st.y * st.width + st.x;
    const double* px = st.image + 3 * idx;
    double q[3];
    for (int c = 0; c < 3; c++) q[c] = (px[c] + err[c]) * st.cw[c];

    const int j = nearest(q, st.pal_scaled.data(), st.k);
    st.out[idx] = j;

    // shift queue, push new error (pixel minus chosen palette color)
    std::memmove(st.queue[0], st.queue[1], sizeof(double) * 15 * 3);
    for (int c = 0; c < 3; c++)
        st.queue[15][c] = px[c] - st.palette[3 * j + c];
}

enum Dir { NONE, UP, LEFT, RIGHT, DOWN };

void move_(DitherState& st, Dir d) {
    if (st.x >= 0 && st.x < st.width && st.y >= 0 && st.y < st.height)
        dither_pixel(st);
    switch (d) {
        case LEFT:  st.x--; break;
        case RIGHT: st.x++; break;
        case UP:    st.y--; break;
        case DOWN:  st.y++; break;
        case NONE:  break;
    }
}

// UP-start Hilbert traversal with the reference's direction grammar
// (riemersma.c:176-257 semantics).
void traverse(DitherState& st, int level, Dir dir) {
    if (level == 1) {
        switch (dir) {
            case LEFT:  move_(st, RIGHT); move_(st, DOWN);  move_(st, LEFT);  break;
            case RIGHT: move_(st, LEFT);  move_(st, UP);    move_(st, RIGHT); break;
            case UP:    move_(st, DOWN);  move_(st, RIGHT); move_(st, UP);    break;
            case DOWN:  move_(st, UP);    move_(st, LEFT);  move_(st, DOWN);  break;
            default: break;
        }
        return;
    }
    switch (dir) {
        case LEFT:
            traverse(st, level - 1, UP);    move_(st, RIGHT);
            traverse(st, level - 1, LEFT);  move_(st, DOWN);
            traverse(st, level - 1, LEFT);  move_(st, LEFT);
            traverse(st, level - 1, DOWN);  break;
        case RIGHT:
            traverse(st, level - 1, DOWN);  move_(st, LEFT);
            traverse(st, level - 1, RIGHT); move_(st, UP);
            traverse(st, level - 1, RIGHT); move_(st, RIGHT);
            traverse(st, level - 1, UP);    break;
        case UP:
            traverse(st, level - 1, LEFT);  move_(st, DOWN);
            traverse(st, level - 1, UP);    move_(st, RIGHT);
            traverse(st, level - 1, UP);    move_(st, UP);
            traverse(st, level - 1, RIGHT); break;
        case DOWN:
            traverse(st, level - 1, RIGHT); move_(st, UP);
            traverse(st, level - 1, DOWN);  move_(st, LEFT);
            traverse(st, level - 1, DOWN);  move_(st, DOWN);
            traverse(st, level - 1, LEFT);  break;
        default: break;
    }
}

}  // namespace

extern "C" {

// Exact serial Riemersma dither.
// image: (h*w, 3) doubles, linear Rec2020, row-major scan order.
// palette: (k, 3) doubles. out: int32 (h*w).
// cw: 3 channel weights (luminance-weighted NN space).
void oracle_riemersma_dither(const double* image, long width, long height,
                             const double* palette, int k,
                             const double* cw, int32_t* out) {
    DitherState st;
    st.width = width; st.height = height; st.k = k;
    st.image = image; st.palette = palette; st.out = out;
    st.cw[0] = cw[0]; st.cw[1] = cw[1]; st.cw[2] = cw[2];
    st.pal_scaled.resize((size_t)k * 3);
    for (int i = 0; i < k; i++)
        for (int c = 0; c < 3; c++)
            st.pal_scaled[3 * i + c] = palette[3 * i + c] * cw[c];
    std::memset(st.queue, 0, sizeof(st.queue));
    const double m = std::exp(std::log(16.0) / 15.0);
    double v = 1.0;
    for (int i = 0; i < 16; i++) { st.qweights[i] = v / 16.0; v *= m; }

    long mx = std::max(width, height);
    int level = 0;
    long value = mx;
    while (value > 1) { value >>= 1; level++; }
    if ((1L << level) < mx) level++;

    if (level > 0) {
        traverse(st, level, UP);
        move_(st, NONE);
    }
}

// Batch exact NN mapping (FLANN replacement semantics).
void oracle_nn_map(const double* colors, long n, const double* palette,
                   int k, int32_t* out) {
    for (long i = 0; i < n; i++)
        out[i] = nearest(colors + 3 * i, palette, k);
}

// One MBD raster scan, forward or inverse (pyx:54-156 semantics).
// img/l/u/d: (rows, cols) float32 row-major; l/u/d updated in place.
void oracle_mbd_scan(const float* img, float* l, float* u, float* d,
                     long rows, long cols, int inverse) {
    auto at = [cols](long x, long y) { return (size_t)x * cols + y; };
    if (!inverse) {
        for (long x = 1; x < rows - 1; x++) {
            for (long y = 1; y < cols - 1; y++) {
                const float ix = img[at(x, y)];
                const float dd = d[at(x, y)];
                const float u1 = u[at(x - 1, y)], l1 = l[at(x - 1, y)];
                const float u2 = u[at(x, y - 1)], l2 = l[at(x, y - 1)];
                const float b1 = std::max(u1, ix) - std::min(l1, ix);
                const float b2 = std::max(u2, ix) - std::min(l2, ix);
                if (dd <= b1 && dd <= b2) continue;
                if (b1 < dd && b1 <= b2) {
                    d[at(x, y)] = b1;
                    u[at(x, y)] = std::max(u1, ix);
                    l[at(x, y)] = std::min(l1, ix);
                } else {
                    d[at(x, y)] = b2;
                    u[at(x, y)] = std::max(u2, ix);
                    l[at(x, y)] = std::min(l2, ix);
                }
            }
        }
    } else {
        for (long x = rows - 2; x > 1; x--) {
            for (long y = cols - 2; y > 1; y--) {
                const float ix = img[at(x, y)];
                const float dd = d[at(x, y)];
                const float u1 = u[at(x + 1, y)], l1 = l[at(x + 1, y)];
                const float u2 = u[at(x, y + 1)], l2 = l[at(x, y + 1)];
                const float b1 = std::max(u1, ix) - std::min(l1, ix);
                const float b2 = std::max(u2, ix) - std::min(l2, ix);
                if (dd <= b1 && dd <= b2) continue;
                if (b1 < dd && b1 <= b2) {
                    d[at(x, y)] = b1;
                    u[at(x, y)] = std::max(u1, ix);
                    l[at(x, y)] = std::min(l1, ix);
                } else {
                    d[at(x, y)] = b2;
                    u[at(x, y)] = std::max(u2, ix);
                    l[at(x, y)] = std::min(l2, ix);
                }
            }
        }
    }
}

// Vectorized Hilbert xy->d (same transform as ops/hilbert.py), for
// host-side permutation building on huge images.
void oracle_hilbert_d(const uint32_t* xs, const uint32_t* ys, long n,
                      int order, uint64_t* out) {
    for (long i = 0; i < n; i++) {
        uint32_t x = xs[i], y = ys[i];
        uint64_t dacc = 0;
        for (uint32_t s = 1u << (order - 1); s > 0; s >>= 1) {
            const uint32_t rx = (x & s) ? 1 : 0;
            const uint32_t ry = (y & s) ? 1 : 0;
            dacc += (uint64_t)s * s * ((3 * rx) ^ ry);
            if (ry == 0) {
                if (rx == 1) { x = s - 1 - x; y = s - 1 - y; }
                const uint32_t t = x; x = y; y = t;
            }
        }
        out[i] = dacc;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// 24-bit LUT palette mapping: fused pack + gather + int32 widen, threaded.
// out[i] = (int32) lut[(r<<16)|(g<<8)|b] — the host half of the LUT wire
// path (ops/lut.py): one pass over the image, with the public int32 widen
// fused into the gather (no separate numpy astype pass over N elements).
// The table must be padded with >= 4 zero bytes past its end: the AVX-512
// path gathers 4-byte windows at byte offsets into the u8/u16 table.
// ---------------------------------------------------------------------------
namespace {

inline uint32_t pack24(const uint8_t* p) {
    return ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
}

template <typename T>
void lut_map_range(const uint8_t* rgb, long lo, long hi, const T* lut,
                   int32_t* out) {
    // Software-prefetch the table entry PF iterations ahead: the gather is
    // latency-bound on table misses (the 16.7 MB LUT exceeds L2).
    constexpr long PF = 24;
    for (long i = lo; i < hi; i++) {
        if (i + PF < hi)
            __builtin_prefetch(&lut[pack24(rgb + 3 * (i + PF))], 0, 1);
        out[i] = (int32_t)lut[pack24(rgb + 3 * i)];
    }
}

#if defined(__x86_64__)
// vpgatherdd amortizes the table-access latency 16-wide; indices are packed
// scalar into an L1-resident chunk first. sizeof(T) in {1, 2}: the gather
// reads a dword window at byte offset sizeof(T)*code and masks to the
// element — hence the required table tail padding.
template <typename T>
__attribute__((target("avx512f")))
void lut_map_range_avx512(const uint8_t* rgb, long lo, long hi, const T* lut,
                          int32_t* out) {
    constexpr long CH = 4096;
    alignas(64) uint32_t codes[CH];
    // 1ull avoids shift-count overflow; only sizeof(T) in {1, 2} is ever
    // instantiated here (see the if constexpr in lut_map_dispatch).
    const __m512i mask =
        _mm512_set1_epi32((int)((1ull << (8 * sizeof(T))) - 1));
    for (long base = lo; base < hi; base += CH) {
        const long m = std::min(CH, hi - base);
        const uint8_t* p = rgb + 3 * base;
        for (long i = 0; i < m; i++) codes[i] = pack24(p + 3 * i);
        long i = 0;
        // scalar prologue to a 64-byte-aligned output (NT-store contract)
        while (i < m && (((uintptr_t)(out + base + i)) & 63))
            { out[base + i] = (int32_t)lut[codes[i]]; i++; }
        for (; i + 16 <= m; i += 16) {
            __m512i idx = _mm512_loadu_si512((const void*)(codes + i));
            __m512i g = _mm512_i32gather_epi32(idx, (const int*)lut,
                                               sizeof(T));
            _mm512_stream_si512((__m512i*)(out + base + i),
                                _mm512_and_si512(g, mask));
        }
        for (; i < m; i++) out[base + i] = (int32_t)lut[codes[i]];
    }
    _mm_sfence();
}
#endif

template <typename T>
void lut_map_dispatch(const uint8_t* rgb, long lo, long hi, const T* lut,
                      int32_t* out) {
#if defined(__x86_64__)
    // if constexpr: the AVX-512 template (dword-window gather) must never be
    // instantiated for 4-byte T — its narrowing mask would be a no-op and
    // the int32 table needs no widening anyway.
    if constexpr (sizeof(T) <= 2) {
        if (__builtin_cpu_supports("avx512f")) {
            lut_map_range_avx512<T>(rgb, lo, hi, lut, out);
            return;
        }
    }
#endif
    lut_map_range<T>(rgb, lo, hi, lut, out);
}

template <typename T>
void lut_map_threaded(const uint8_t* rgb, long n, const T* lut, int32_t* out,
                      int nthreads) {
    if (nthreads < 2 || n < (1L << 20)) {
        lut_map_dispatch(rgb, 0, n, lut, out);
        return;
    }
    std::vector<std::thread> ts;
    const long step = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const long lo = t * step;
        const long hi = std::min(n, lo + step);
        if (lo >= hi) break;
        ts.emplace_back(lut_map_dispatch<T>, rgb, lo, hi, lut, out);
    }
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Split pack / gather halves: the 24-bit pack depends only on the image, so
// the pipeline runs it in a BACKGROUND thread while the device computes the
// palette + LUT; once the table arrives, only the latency-bound gather
// remains on the critical path (VERDICT r4 next #1).
// ---------------------------------------------------------------------------

void pack_codes_range(const uint8_t* rgb, long lo, long hi, uint32_t* out) {
#if defined(__x86_64__)
    // write-once buffer: non-temporal 4-byte stores skip the RFO read
    for (long i = lo; i < hi; i++)
        _mm_stream_si32((int*)(out + i), (int)pack24(rgb + 3 * i));
    _mm_sfence();
#else
    for (long i = lo; i < hi; i++) out[i] = pack24(rgb + 3 * i);
#endif
}

template <typename T>
void lut_map_codes_range(const uint32_t* codes, long lo, long hi,
                         const T* lut, int32_t* out) {
    constexpr long PF = 24;
    for (long i = lo; i < hi; i++) {
        if (i + PF < hi)
            __builtin_prefetch(&lut[codes[i + PF]], 0, 1);
        out[i] = (int32_t)lut[codes[i]];
    }
}

#if defined(__x86_64__)
// Non-temporal stores: the (N,) int32 output is written once and not
// re-read, so regular stores pay a read-for-ownership on every cache line
// (400 MB of extra read traffic at 100 MP; the map is memory-bound, not
// compute-bound).
template <typename T>
__attribute__((target("avx512f")))
void lut_map_codes_range_avx512(const uint32_t* codes, long lo, long hi,
                                const T* lut, int32_t* out) {
    const __m512i mask =
        _mm512_set1_epi32((int)((1ull << (8 * sizeof(T))) - 1));
    long i = lo;
    // scalar prologue up to a 64-byte-aligned output address
    while (i < hi && (((uintptr_t)(out + i)) & 63))
        { out[i] = (int32_t)lut[codes[i]]; i++; }
    for (; i + 16 <= hi; i += 16) {
        __m512i idx = _mm512_loadu_si512((const void*)(codes + i));
        __m512i g = _mm512_i32gather_epi32(idx, (const int*)lut, sizeof(T));
        _mm512_stream_si512((__m512i*)(out + i), _mm512_and_si512(g, mask));
    }
    _mm_sfence();
    for (; i < hi; i++) out[i] = (int32_t)lut[codes[i]];
}
#endif

template <typename T>
void lut_map_codes_dispatch(const uint32_t* codes, long lo, long hi,
                            const T* lut, int32_t* out) {
#if defined(__x86_64__)
    if constexpr (sizeof(T) <= 2) {
        if (__builtin_cpu_supports("avx512f")) {
            lut_map_codes_range_avx512<T>(codes, lo, hi, lut, out);
            return;
        }
    }
#endif
    lut_map_codes_range<T>(codes, lo, hi, lut, out);
}

template <typename T>
void lut_map_codes_threaded(const uint32_t* codes, long n, const T* lut,
                            int32_t* out, int nthreads) {
    if (nthreads < 2 || n < (1L << 20)) {
        lut_map_codes_dispatch(codes, 0, n, lut, out);
        return;
    }
    std::vector<std::thread> ts;
    const long step = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const long lo = t * step;
        const long hi = std::min(n, lo + step);
        if (lo >= hi) break;
        ts.emplace_back(lut_map_codes_dispatch<T>, codes, lo, hi, lut, out);
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

void oracle_lut_map_u8(const uint8_t* rgb, long n, const uint8_t* lut,
                       int32_t* out, int nthreads) {
    lut_map_threaded(rgb, n, lut, out, nthreads);
}

void oracle_lut_map_u16(const uint8_t* rgb, long n, const uint16_t* lut,
                        int32_t* out, int nthreads) {
    lut_map_threaded(rgb, n, lut, out, nthreads);
}

void oracle_lut_map_i32(const uint8_t* rgb, long n, const int32_t* lut,
                        int32_t* out, int nthreads) {
    lut_map_threaded(rgb, n, lut, out, nthreads);
}

// Pack-only half: codes[i] = (r<<16)|(g<<8)|b. Run in a background thread
// while the device builds the LUT (see lut.CodesPrefetch).
void oracle_pack_codes(const uint8_t* rgb, long n, uint32_t* out,
                       int nthreads) {
    if (nthreads < 2 || n < (1L << 20)) {
        pack_codes_range(rgb, 0, n, out);
        return;
    }
    std::vector<std::thread> ts;
    const long step = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const long lo = t * step;
        const long hi = std::min(n, lo + step);
        if (lo >= hi) break;
        ts.emplace_back(pack_codes_range, rgb, lo, hi, out);
    }
    for (auto& th : ts) th.join();
}

// Gather-only half over precomputed codes.
void oracle_lut_map_codes_u8(const uint32_t* codes, long n,
                             const uint8_t* lut, int32_t* out, int nthreads) {
    lut_map_codes_threaded(codes, n, lut, out, nthreads);
}

void oracle_lut_map_codes_u16(const uint32_t* codes, long n,
                              const uint16_t* lut, int32_t* out,
                              int nthreads) {
    lut_map_codes_threaded(codes, n, lut, out, nthreads);
}

void oracle_lut_map_codes_i32(const uint32_t* codes, long n,
                              const int32_t* lut, int32_t* out,
                              int nthreads) {
    lut_map_codes_threaded(codes, n, lut, out, nthreads);
}

// RLE decode of the LUT wire format (ops/lut.py): packed[i] =
// (pos << 8) | value with positions strictly ascending; run i covers
// [pos_i, pos_{i+1}) and the last run extends to table_size. memset per run
// replaces numpy's np.repeat.
void oracle_rle_decode_u8(const uint32_t* packed, long nruns, uint8_t* out,
                          long table_size, int nthreads) {
    if (nruns <= 0) return;
    auto fill = [packed, nruns, out, table_size](long rlo, long rhi) {
        for (long r = rlo; r < rhi; r++) {
            const long pos = (long)(packed[r] >> 8);
            const long end =
                (r + 1 < nruns) ? (long)(packed[r + 1] >> 8) : table_size;
            if (end > pos)
                memset(out + pos, (int)(packed[r] & 0xFF),
                       (size_t)(end - pos));
        }
    };
    if (nthreads < 2 || nruns < (1L << 16)) {
        fill(0, nruns);
        return;
    }
    std::vector<std::thread> ts;
    const long step = (nruns + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const long lo = t * step;
        const long hi = std::min(nruns, lo + step);
        if (lo >= hi) break;
        ts.emplace_back(fill, lo, hi);
    }
    for (auto& th : ts) th.join();
}

// RLE v2 decode (ops/lut.py _rle_encode_u8_v2): u16 words
// (delta << 8) | value, pos_i = pos_{i-1} + delta_i, pos_0 = 0; run i
// covers [pos_i, pos_{i+1}) and the last run extends to table_size.
// Serial: the ~650k-word cumsum + memset-per-run takes a few ms.
void oracle_rle_decode_u8_v2(const uint16_t* words, long nruns, uint8_t* out,
                             long table_size) {
    if (nruns <= 0) return;
    long pos = 0;
    for (long r = 0; r < nruns; r++) {
        pos += (long)(words[r] >> 8);
        const long end = (r + 1 < nruns)
            ? pos + (long)(words[r + 1] >> 8) : table_size;
        if (end > pos && pos < table_size)
            memset(out + pos, (int)(words[r] & 0xFF),
                   (size_t)(std::min(end, table_size) - pos));
    }
}

// u16-value variant (ops/lut.py _rle_encode_u16_v2): u32 words
// (delta << 16) | value, same position scheme; fills a uint16 table.
void oracle_rle_decode_u16_v2(const uint32_t* words, long nruns,
                              uint16_t* out, long table_size) {
    if (nruns <= 0) return;
    long pos = 0;
    for (long r = 0; r < nruns; r++) {
        pos += (long)(words[r] >> 16);
        const long end = (r + 1 < nruns)
            ? pos + (long)(words[r + 1] >> 16) : table_size;
        if (end > pos && pos < table_size)
            std::fill_n(out + pos, (size_t)(std::min(end, table_size) - pos),
                        (uint16_t)(words[r] & 0xFFFF));
    }
}

}  // extern "C"
