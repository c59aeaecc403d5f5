// The encoder's windowed autocorrelation (kernel K11 of flac_tpu_torch).
//
// Replaces the windows, the autocorrelation and the combine of
// flac_tpu/models/subframe.py search_and_realize (:148-156: xw =
// float32(x) * windows, flac_tpu/ops/lpc.py:64 autocorrelation through
// :109 autocorrelation_mxu, and the einsum by the [A, W] combine matrix),
// which XLA fuses into the jitted encode_batch on the TPU and the port ran
// as a Gram matmul and some forty small torch kernels a batch.  Same
// contract as flac_tpu_torch/ops/lpc.py autocorrelation_plain, its plain
// version, bit for bit: for every (frame and channel candidate) row r of
// x [R, N] (int32, or int64 on the 33-bit side), the windows [W, N]
// float32 and the combine [A, W] float64, autoc[r, a, l] for l = 0..O.
//
// Exactness: the plain version's order of operations is flac_tpu's
// blocked Gram product (autocorrelation_mxu, F = 128) with each sum in a
// fixed order.  Each windowed sample is float32(x) * w rounded to float32
// (__int2float_rn or __ll2float_rn, then __fmul_rn).  Column t of 128
// sums its blocks' products in ascending order, each step
// p = __fmaf_rn(d[n], d[n + l], p), rounded once to float32 (the plain
// version emulates that fused rounding exactly in float64: _fma_float32).
// A block whose first factors d[n] are all +-0 is skipped: each of its
// steps adds an exact +-0, which leaves a nonzero p as it is, so the skip
// gives the same sums up to the sign of a zero one (p is -0 only where a
// product underflowed to -0, which the plain version's next +0 would turn
// into +0; the two compare equal); past N every factor is 0.  The 128 columns
// meet in a fixed float64 tree: within each group of 32 columns c + c+16,
// then c+8, c+4, c+2, c+1, then the halves of the 4 group sums (float64
// addition commutes, so which operand comes first does not matter).  The
// combine adds combine[a, w] * autoc_w (__dmul_rn, then __dadd_rn, never
// contracted) in ascending w, from 0.
//
// Design (Hopper), several windows (-6 to -8): a CTA of 384 threads takes
// two rows (the windows are read once for both) and a pass of up to WPASS
// windows; each (row,
// window) pair's windowed samples are staged in dynamic shared memory a
// tile of 4096 samples and a 32-sample halo at a time: the windows by
// cp.async, every copy of the stage in flight at once, the rows' samples
// by 16-byte loads into registers meanwhile, then the products in place;
// each block of 128 is flagged when its first factors are not all zero
// (a warp ballot).  Then a warp a (row, window, lag part): lane j holds
// the four consecutive columns 4j..4j+3 for each lag of its part
// (part_lags), so a block is one warp; it reads its factors with 16-byte
// shared loads (4 for 52 fmas at -8) and walks only the flagged blocks,
// with no branch between a block's fmas.  The tree is a reduce-scatter of
// shuffles that follows the fixed order (8 float64 shuffles a lag), every
// lag's side by side.  Then the combine, a thread an output.
//
// One window (-3 to -5): that layout leaves one computing warp a row, and
// a lone warp issues its fmas at a fraction of the SM's rate, so a CTA of
// 128 threads takes one row, a thread a column (4 warps a block): every
// load of the row and the window in flight at once, their products into
// shared memory, then thread t walks its column's blocks with 4-byte
// shared loads (a tile whose windowed samples are all zero skipped); the
// tree is a warp's shuffles, every lag side by side, then the 4 warps'
// halves.
//
// The bound at -8 is the fmas that the nonzero blocks need (at the H100's
// 67 TFLOP/s of float32 outside the tensor cores) or the bytes, at -5 the
// bytes (x read once, 4.2 MB: ~1.3 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 4;                 // consecutive Gram columns a lane
constexpr int LANES = 32;
constexpr int BLOCK = COLS * LANES;     // samples a Gram block: one warp
constexpr int TILE = 4096;              // samples a staged tile
constexpr int HALO = 32;                // the largest lag
constexpr int TILE_BLOCKS = TILE / BLOCK;
constexpr int THREADS = 384;            // threads a CTA
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 2;             // rows a CTA
constexpr int WPASS = 6;                // windows a pass, at most
constexpr int PAIRS = MAX_ROWS * WPASS;
constexpr int ONE_THREADS = 128;        // one window: a thread a column
constexpr int ONE_QUADS =               // one window: staged quads a thread
    ((TILE + HALO) / 4 + ONE_THREADS - 1) / ONE_THREADS;
constexpr int UNITS = (TILE_BLOCKS + WARPS) / WARPS;  // stage units a warp
constexpr int PAD = 16;                 // floats past the last region
constexpr int MAX_APOD = 32;            // apodizations (combine rows)
constexpr unsigned FULL = 0xFFFFFFFFu;

// the lags a warp takes under the template of largest lag `maxlag`: all of
// them up to 12 (-5's 9, -8's 13), else parts of 12 (a multiple of 4:
// aligned loads)
__host__ __device__ constexpr int part_lags(int maxlag) {
    return maxlag <= 12 ? maxlag + 1 : 12;
}
// a lag template's parts, two rows' worth, fit the CTA's warps
static_assert(MAX_ROWS * ((HALO + part_lags(HALO)) / part_lags(HALO))
              <= WARPS, "the lag parts of two rows fit a CTA");

struct Args {
    const void* x;                      // [R, N] int32 or int64
    const float* windows;               // [W, N]
    const double* combine;              // [A, W]
    double* out;                        // [R, A, O + 1]
    int R, N, W, A, O;
    int vec;                            // 16-byte loads (N % 4 == 0, aligned)
    int wpass;                          // windows a pass
    int parts;                          // lag parts a window
    int region;                         // floats a (row, window) pair
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(long long v) {
    return __ll2float_rn(v);
}

// samples n..n+3 of a row as float32, zero past N
__device__ __forceinline__ float4 load_x(const int* p, int n, int N,
                                         bool vec) {
    if (vec) {
        if (n >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
        const int4 q = __ldg(reinterpret_cast<const int4*>(p + n));
        return make_float4(to_float(q.x), to_float(q.y), to_float(q.z),
                           to_float(q.w));
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = n + e < N ? to_float(p[n + e]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load_x(const long long* p, int n, int N,
                                         bool vec) {
    if (vec) {
        if (n >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + n));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + n)
                                  + 1);
        return make_float4(to_float(a.x), to_float(a.y), to_float(b.x),
                           to_float(b.y));
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = n + e < N ? to_float(p[n + e]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
}

// ---- PTX helpers ----
// copy 16 (or 4) bytes from device memory into shared memory without
// registers, zero-filled past `bytes` (cp.async; cp_async_wait_all waits
// for this thread's copies)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ---- end of PTX helpers ----

// a lane's factors of block k: the first factors f(c) (columns 4j..4j+3)
// and the second factors s[i] = d[k * BLOCK + 4j + l0 + i], loaded as far
// as the part's nl lags need them.  ONE: every lag in one part (l0 = 0),
// so the first factors are s[0..3] and take no registers of their own.
template <int LP, bool ONE>
struct Factors {
    static constexpr int Q = (LP + 6) / 4;       // 16-byte loads of s
    float s[4 * Q];
    float g[ONE ? 1 : COLS];                     // f where l0 > 0
    __device__ __forceinline__ float f(int c) const {
        if constexpr (ONE) return s[c];
        else return g[c];
    }
    __device__ __forceinline__ void load(const float* d, int k, int lane,
                                         int l0, int nl) {
        const float* p = d + k * BLOCK + COLS * lane;
#pragma unroll
        for (int m = 0; m < Q; ++m) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (4 * m <= nl + 2)
                v = *reinterpret_cast<const float4*>(p + l0 + 4 * m);
            s[4 * m] = v.x; s[4 * m + 1] = v.y;
            s[4 * m + 2] = v.z; s[4 * m + 3] = v.w;
        }
        if constexpr (!ONE) {
            const float4 v = l0 == 0
                ? make_float4(s[0], s[1], s[2], s[3])
                : *reinterpret_cast<const float4*>(p);
            g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
        }
    }
};

// one lag's 128 column sums (lane j's four in v0..v3) through the fixed
// tree; every lane returns the total
__device__ __forceinline__ double tree(double v0, double v1, double v2,
                                       double v3, int lane) {
    // c + c+16 (lanes j and j ^ 4 of an 8-lane group): the lower keeps
    // columns 4j, 4j+1, the upper 4j+2, 4j+3
    const bool up4 = lane & 4;
    const double r0 = __shfl_xor_sync(FULL, up4 ? v0 : v2, 4);
    const double r1 = __shfl_xor_sync(FULL, up4 ? v1 : v3, 4);
    const double a0 = (up4 ? v2 : v0) + r0;
    const double a1 = (up4 ? v3 : v1) + r1;
    // c + c+8 (lanes j ^ 2): the lower keeps a0, the upper a1
    const bool up2 = lane & 2;
    const double b = (up2 ? a1 : a0)
        + __shfl_xor_sync(FULL, up2 ? a0 : a1, 2);
    // c + c+4 (j ^ 1), c + c+2 (j ^ 4), c + c+1 (j ^ 2): every lane of the
    // group ends with its sum
    const double c4 = b + __shfl_xor_sync(FULL, b, 1);
    const double c2 = c4 + __shfl_xor_sync(FULL, c4, 4);
    const double c1 = c2 + __shfl_xor_sync(FULL, c2, 2);
    // the groups' halves: g + g+2 (lane ^ 16), then the two (lane ^ 8)
    const double g2 = c1 + __shfl_xor_sync(FULL, c1, 16);
    return g2 + __shfl_xor_sync(FULL, g2, 8);
}

// MAXLAG: the template's largest lag (O <= MAXLAG)
template <typename X, int MAXLAG>
__global__ void __launch_bounds__(THREADS)
window_autoc_kernel(const Args a) {
    constexpr int LP = part_lags(MAXLAG);
    extern __shared__ __align__(16) float s_d[];    // [pair][region]
    __shared__ int s_flag[PAIRS][TILE_BLOCKS];       // a block not all zero
    __shared__ double s_lag[PAIRS][HALO + 1];        // a pass's reduced lags
    __shared__ double s_comb[MAX_APOD * WPASS];      // a pass's combine
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int N = a.N, O = a.O, L1 = O + 1, W = a.W, A = a.A;
    const int WB = a.wpass, P = a.parts, region = a.region;
    const bool vec = a.vec;
    const int row0 = blockIdx.x * MAX_ROWS;
    const int nrows = min(MAX_ROWS, a.R - row0);
    const X* x = static_cast<const X*>(a.x) + (size_t)row0 * N;
    const int tiles = (N + TILE - 1) / TILE;
    // this warp's (row, window slot, lag part)
    const int r = warp / (WB * P), wb = warp / P % WB, p = warp % P;
    const int pair = r * WB + wb;
    const int l0 = p * LP, nl = min(LP, L1 - l0);
    const bool computes = warp < MAX_ROWS * WB * P && r < nrows;

    for (int w0 = 0; w0 < W; w0 += WB) {
        const int nw = min(WB, W - w0);
        const bool active = computes && wb < nw;
        float acc[COLS][LP];
#pragma unroll
        for (int c = 0; c < COLS; ++c)
#pragma unroll
            for (int l = 0; l < LP; ++l) acc[c][l] = 0.0f;
        for (int tile = 0; tile < tiles; ++tile) {
            const int base = tile * TILE;
            const int nblk = (min(TILE, N - base) + BLOCK - 1) / BLOCK;
            __syncthreads();                  // the last tile's reads done
            // the stage: the windows into row 0's regions by cp.async,
            // every copy in flight at once, and meanwhile the rows' quads
            // of this thread's units (unit b: block b's 32 quads; b ==
            // nblk: the halo's 8) into registers
            const int nq = nblk * LANES + HALO / 4;
            for (int e = t; e < nw * nq; e += THREADS) {
                const int ww = e / nq, q = e - ww * nq, n = base + 4 * q;
                float* dst = s_d + ww * region + 4 * q;
                const float* src = a.windows + (size_t)(w0 + ww) * N;
                if (vec) {
                    cp_async16(dst, src + min(n, N - 4), n < N ? 16 : 0);
                } else {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        cp_async4(dst + k, src + min(n + k, N - 1),
                                  n + k < N ? 4 : 0);
                }
            }
            float4 xv[UNITS][MAX_ROWS];
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                const int b = warp + u * WARPS, i = b * BLOCK + 4 * lane;
                const bool in = b < nblk || (b == nblk && 4 * lane < HALO);
#pragma unroll
                for (int rr = 0; rr < MAX_ROWS; ++rr)
                    xv[u][rr] = rr < nrows && in
                        ? load_x(x + (size_t)rr * N, base + i, N, vec)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            if (tile == 0 && t < A * nw)      // the pass's combine columns
                s_comb[t] = a.combine[(size_t)(t / nw) * W + w0 + t % nw];
            cp_async_wait_all();
            __syncthreads();
            // each pair's windowed samples, in place over the window in
            // row 0's regions; a block flagged where they are not all zero
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                const int b = warp + u * WARPS, i = b * BLOCK + 4 * lane;
                if (b > nblk) break;
                const bool in = b < nblk || 4 * lane < HALO;
#pragma unroll
                for (int ww = 0; ww < WPASS; ++ww) {
                    if (ww >= nw) break;
                    const float4 wv = in
                        ? *reinterpret_cast<const float4*>(s_d + ww * region
                                                           + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                    for (int rr = 0; rr < MAX_ROWS; ++rr) {
                        if (rr >= nrows) break;
                        const float4 d = make_float4(
                            __fmul_rn(xv[u][rr].x, wv.x),
                            __fmul_rn(xv[u][rr].y, wv.y),
                            __fmul_rn(xv[u][rr].z, wv.z),
                            __fmul_rn(xv[u][rr].w, wv.w));
                        const int q = rr * WB + ww;
                        if (in)
                            *reinterpret_cast<float4*>(s_d + q * region + i)
                                = d;
                        if (b < nblk) {
                            const unsigned any = __ballot_sync(
                                FULL, d.x != 0.f || d.y != 0.f
                                || d.z != 0.f || d.w != 0.f);
                            if (lane == 0) s_flag[q][b] = any != 0u;
                        }
                    }
                }
            }
            __syncthreads();
            if (!active) continue;
            // the flagged blocks in ascending order
            const float* d = s_d + pair * region;
            unsigned mask = __ballot_sync(FULL, lane < nblk
                                          && s_flag[pair][lane]);
            while (mask != 0u) {
                Factors<LP, (LP > MAXLAG)> cur;
                cur.load(d, __ffs(mask) - 1, lane, l0, nl);
                mask &= mask - 1;
#pragma unroll
                for (int c = 0; c < COLS; ++c)
#pragma unroll
                    for (int l = 0; l < LP; ++l)   // lags past nl unused
                        acc[c][l] = __fmaf_rn(cur.f(c), cur.s[c + l],
                                              acc[c][l]);
            }
        }
        // the trees of every lag side by side (float32 to float64 is
        // exact)
        if (active) {
#pragma unroll
            for (int l = 0; l < LP; ++l) {
                const double v = tree(acc[0][l], acc[1][l], acc[2][l],
                                      acc[3][l], lane);
                if (lane == 0 && l < nl) s_lag[pair][l0 + l] = v;
            }
        }
        __syncthreads();
        // the combine, in ascending w: out[a] = out[a] + c[a, w] * autoc_w
        for (int o = t; o < nrows * A * L1; o += THREADS) {
            const int rr = o / (A * L1), ai = o / L1 % A, l = o % L1;
            double* dst = a.out + ((size_t)(row0 + rr) * A + ai) * L1 + l;
            double s = w0 == 0 ? 0.0 : *dst;
            for (int ww = 0; ww < nw; ++ww)
                s = __dadd_rn(s, __dmul_rn(s_comb[ai * nw + ww],
                                           s_lag[rr * WB + ww][l]));
            *dst = s;
        }
    }
}

// One window (W == 1): a CTA a row, a thread a column.  Same sums, same
// trees and the same combine as window_autoc_kernel.
template <typename X, int MAXLAG>
__global__ void __launch_bounds__(ONE_THREADS)
window_autoc_kernel_one_window(const Args a) {
    static_assert(ONE_THREADS == BLOCK, "a thread a column of a block");
    __shared__ __align__(16) float s_d[ONE_QUADS * 4 * ONE_THREADS];
    __shared__ double s_warp[ONE_THREADS / 32][MAXLAG + 1];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int N = a.N, O = a.O, L1 = O + 1;
    const bool vec = a.vec;
    const X* x = static_cast<const X*>(a.x) + (size_t)blockIdx.x * N;
    const float* win = a.windows;
    float acc[MAXLAG + 1];
#pragma unroll
    for (int l = 0; l <= MAXLAG; ++l) acc[l] = 0.0f;
    for (int base = 0; base < N; base += TILE) {
        __syncthreads();                      // the last tile's reads done
        // the tile and its halo: every load in flight, then the products
        float4 xv[ONE_QUADS], wv[ONE_QUADS];
#pragma unroll
        for (int q = 0; q < ONE_QUADS; ++q) {
            const int n = base + 4 * (t + q * ONE_THREADS);
            xv[q] = load_x(x, n, N, vec);
            if (vec) {
                wv[q] = n < N ? __ldg(reinterpret_cast<const float4*>(win + n))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v[e] = n + e < N ? win[n + e] : 0.f;
                wv[q] = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
        bool nonzero = false;
#pragma unroll
        for (int q = 0; q < ONE_QUADS; ++q) {
            const float4 d = make_float4(__fmul_rn(xv[q].x, wv[q].x),
                                         __fmul_rn(xv[q].y, wv[q].y),
                                         __fmul_rn(xv[q].z, wv[q].z),
                                         __fmul_rn(xv[q].w, wv[q].w));
            *reinterpret_cast<float4*>(s_d + 4 * (t + q * ONE_THREADS)) = d;
            nonzero |= d.x != 0.f || d.y != 0.f || d.z != 0.f || d.w != 0.f;
        }
        // a tile whose windowed samples are all zero adds zeros: skipped
        // (a test a block would cost the loop its pipelined loads)
        const bool live = __syncthreads_or(nonzero);
        // column t of each block of this tile, in ascending order
        const int nblk = live
            ? (min(TILE, N - base) + ONE_THREADS - 1) / ONE_THREADS : 0;
        for (int k = 0; k < nblk; ++k) {
            const int i = k * ONE_THREADS + t;
            const float d0 = s_d[i];
#pragma unroll
            for (int l = 0; l <= MAXLAG; ++l)
                if (l <= O) acc[l] = __fmaf_rn(d0, s_d[i + l], acc[l]);
        }
    }
    // the tree: a warp's columns c + c+16, c+8, c+4, c+2, c+1, then the
    // 4 groups' halves (float32 to float64 is exact); every lag of the
    // template side by side (past O the sums are 0, and unused)
#pragma unroll
    for (int l = 0; l <= MAXLAG; ++l) {
        double v = acc[l];
#pragma unroll
        for (int h = 16; h > 0; h >>= 1) v += __shfl_down_sync(FULL, v, h);
        if (lane == 0) s_warp[warp][l] = v;
    }
    __syncthreads();
    if (t < L1) {
        const double v = (s_warp[0][t] + s_warp[2][t])
            + (s_warp[1][t] + s_warp[3][t]);
        double* out = a.out + (size_t)blockIdx.x * a.A * L1 + t;
        for (int ai = 0; ai < a.A; ++ai)      // out[a] = 0 + c[a, 0] * v
            out[(size_t)ai * L1] = __dadd_rn(0.0, __dmul_rn(a.combine[ai], v));
    }
}

// the dynamic shared memory a launch asks for
size_t smem_bytes(const Args& a) {
    return ((size_t)MAX_ROWS * a.wpass * a.region + PAD) * sizeof(float);
}

template <typename X, int MAXLAG>
int launch_with(const Args& a, cudaStream_t s) {
    // the largest dynamic shared memory any launch takes, set once (the
    // first launch of a template is never captured into a graph)
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        window_autoc_kernel<X, MAXLAG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(((size_t)PAIRS * (TILE + HALO) + PAD) * sizeof(float)));
    if (opt_in != cudaSuccess) return (int)opt_in;
    const int ctas = (a.R + MAX_ROWS - 1) / MAX_ROWS;
    window_autoc_kernel<X, MAXLAG><<<ctas, THREADS, smem_bytes(a), s>>>(a);
    return (int)cudaGetLastError();
}

template <typename X, int MAXLAG>
int launch_one_window(const Args& a, cudaStream_t s) {
    window_autoc_kernel_one_window<X, MAXLAG><<<a.R, ONE_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <typename X>
int launch(const Args& a, cudaStream_t s) {
    if (a.W == 1) {
        if (a.O <= 8) return launch_one_window<X, 8>(a, s);
        else if (a.O <= 12) return launch_one_window<X, 12>(a, s);
        else return launch_one_window<X, 32>(a, s);
    }
    if (a.O <= 8) return launch_with<X, 8>(a, s);
    else if (a.O <= 12) return launch_with<X, 12>(a, s);
    else return launch_with<X, 32>(a, s);
}

}  // namespace

extern "C" {

// K11 on R = B * CH rows of N samples, W windows, A apodizations and lags
// 0..O (1 <= O <= 32, O < N): x (int64 when x64), windows, combine, out
// (see Args), all device pointers.  Returns the CUDA error code of the
// launch (0 on success).
int flac_window_autoc(const void* x, const void* windows, const void* combine,
                      void* out, int R, int N, int W, int A, int O, int x64,
                      void* stream) {
    if (R <= 0 || A <= 0) return 0;
    if (N < 2 || W < 1 || O < 1 || O > HALO || O >= N || A > MAX_APOD)
        return (int)cudaErrorInvalidValue;
    const int lp = part_lags(O <= 8 ? 8 : O <= 12 ? 12 : 32);
    const int parts = (O + lp) / lp;                 // ceil((O + 1) / lp)
    int wpass = W < WPASS ? W : WPASS;
    while (MAX_ROWS * wpass * parts > WARPS) --wpass;
    const int blocks = (N + BLOCK - 1) / BLOCK;
    const int region = (blocks < TILE_BLOCKS ? blocks : TILE_BLOCKS) * BLOCK
        + HALO;
    const Args a{x, (const float*)windows, (const double*)combine,
                 (double*)out, R, N, W, A, O,
                 (int)(N % 4 == 0 && ((uintptr_t)x & 15) == 0
                       && ((uintptr_t)windows & 15) == 0),
                 wpass, parts, region};
    const cudaStream_t s = (cudaStream_t)stream;
    return x64 ? launch<long long>(a, s) : launch<int>(a, s);
}

}  // extern "C"
