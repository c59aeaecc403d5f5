// The encoder's candidate residuals (kernel K8 of flac_tpu_torch).
//
// Replaces flac_tpu/ops/fixed.py fixed_residuals_all (:44) and
// flac_tpu/ops/lpc.py lpc_residual (:315: its "i32" and "f64" modes, with
// the range analysis of :344-349), with the masks, the wide fixed path and
// f_ok of flac_tpu/models/subframe.py:130-146, the LPC residual call at
// :224-227 and the res_all/order_all concatenation at :240-241, which XLA
// fuses into the jitted encode_batch on the TPU and the port ran as some
// thirty small torch kernels a batch.  Same contract as
// flac_tpu_torch/models/subframe.py candidate_residuals_plain, its plain
// version: from the signal x[r, 0..N) of every (frame and channel
// candidate) row r, each row's five fixed-order residuals and its AC LPC
// candidates' residuals x[n] - (sum_j qc[j] x[n-1-j] >> shift), zero at
// n < order, as res[r, 5 + AC, N] int32, with order_all, the fixed rows'
// range flags f_ok and the LPC rows' fit_ok.
//
// Exactness: narrow fixed rows and the "i32" mode wrap in 32-bit two's
// complement as the plain version's int32 tensors do (a ring: the order
// of the sums does not matter), so even a row whose range analysis fails
// is equal; that analysis (fits) is the plain version's float64 on
// sum |qc|, bps and the shift, every quantity an exact integer or power
// of two.  Wide fixed rows and the "f64" mode are exact where the plain
// version's float64 is (products <= 2^47, sums <= 2^52): on int32
// signals the taps are float64 fma on integer-valued doubles (a product
// of an int32 sample and a coefficient below 2^15 and a sum of 32 such
// are exact integers, so the fma rounds nothing), on int64 signals (the
// 33-bit side) and in the wide fixed rows int64; the exact sum converts
// to int64 and floor(pred 2^-shift) is an arithmetic right shift.  Their
// flag is max |res| < 2^31 over the masked row.  On a row whose flag is false the
// plain version's cast of an out-of-range double has no defined value; K8
// writes the low 32 bits there.  The taps stop at the smaller of the
// candidate's order and max_j (lpc_residual's loop bound): the table of
// coefficients in shared memory is zero past it.
//
// Design (Hopper): every candidate row of a row's samples in one CTA of
// 128 threads.  A row takes up to CLUSTER CTAs, as many as let all rows
// fill one wave of the CTAs the card holds at once (grid_of, from the
// occupancy: 2 a row for 64 frames of stereo, 1 for 5.1), each a run of
// consecutive spans of 512 samples.  A CTA stages its spans through a
// ring of RING buffers in shared memory by cp.async, each span with the
// 32 samples before it (the longest history), RING - 1 spans ahead of the
// one it computes, beside the coefficients of up to BLOCK candidates
// (zero past each one's taps; doubles for the float64 taps), staged once.
// A thread takes 4 consecutive samples of a span: the fixed orders are
// differences of its 8-sample window in registers; the LPC candidates go
// in chunks of up to 5 (4 with 64-bit sums), taps outer and candidates
// inner, 4 taps a step: one 16-byte shared load of the next 4 history
// samples slides the thread's window, and a broadcast load of each
// candidate's next 4 coefficients feeds 16 multiply-adds into its 4
// sums.  No mask where
// all 4 samples lie past every order and below N.  Each row's 4
// residuals go out as one 16-byte store (scalar where N % 4 != 0), under
// the default cache policy: K7 reads res_all next.  The range flags of
// wide fixed rows and of "f64" rows are ORs over a row's spans: those
// forms launch a row's CTAs as one thread block cluster; each CTA ORs its
// flags over its warps and stores them into rank 0's shared memory, and
// after one cluster barrier rank 0 writes them: nothing is read back and
// nothing is left for the next launch.  The bound is bytes: x read once
// and res written once (29 MB at -5, 63 MB at -8).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "cluster.cuh"

constexpr int THREADS = 128;           // threads a CTA
constexpr int PER_THREAD = 4;          // consecutive samples a thread
constexpr int SPAN = THREADS * PER_THREAD;   // samples a span
constexpr int HALO = 32;               // format.MAX_LPC_ORDER: history
constexpr int RING = 4;                // spans staged ahead, at most
constexpr int FIXED = 5;               // fixed orders 0..4
constexpr int MAX_ORDER = 32;          // coefficients a candidate
constexpr int BLOCK = 48;              // candidates a coefficient table
constexpr int CLUSTER = 8;             // CTAs a row at most
constexpr long long RANGE = 1LL << 31;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const void* x;             // [R, N] int32 or int64
    const int* qc;             // [R, AC, 32]
    const int* qshift;         // [R, AC]
    const int* order;          // [R, AC]
    const int* bps;            // [R]
    int* res;                  // [R, 5 + AC, N]
    int* order_all;            // [R, 5 + AC]
    unsigned char* f_ok;       // [R, 5]
    unsigned char* fit_ok;     // [R, AC]
    int R, AC, N, max_j;
    int vec;                   // N % 4 == 0 and res 16-byte aligned
    int xvec;                  // x's rows start 16-byte aligned
    int spans_per_part;        // consecutive spans a CTA
};

// exact 2.0**e (ops/lpc.py _pow2: the table of 2^-1075 .. 2^1024)
__device__ __forceinline__ double pow2(int e) {
    if (e <= -1075) return 0.0;
    if (e >= 1024) return __longlong_as_double(0x7FF0000000000000LL);
    if (e >= -1022) return __longlong_as_double((long long)(e + 1023) << 52);
    return __longlong_as_double(1LL << (e + 1074));
}

// lpc_residual's "i32" range analysis in float64: sum |q| over all 32
// coefficients (torch's int32 abs, which leaves -2^31 as it is) times
// 2^(bps-1) and the residual bound 2^(bps-1) + floor(that 2^-shift),
// both below 2^31
__device__ bool fits_i32(const int* q, int bps, int shift) {
    double s = 0.0;
    for (int j = 0; j < MAX_ORDER; ++j) {
        const int v = q[j];
        s = __dadd_rn(s, (double)(v < 0 ? (int)(0u - (unsigned)v) : v));
    }
    const double amp = pow2((int)((unsigned)bps - 1u));
    const double pred = __dmul_rn(s, amp);
    const double resb = __dadd_rn(
        amp, floor(__dmul_rn(pred, pow2((int)(0u - (unsigned)shift)))));
    return pred < 2147483648.0 && resb < 2147483648.0;
}

// torch's >> by an int32 amount: a shift past the width, or below 0,
// fills with the sign (the amount clamped once a candidate)
__device__ __forceinline__ int clamp_shift(int s, int width) {
    return (s < 0 || s > width - 1) ? width - 1 : s;
}

// |v| >= 2^31
__device__ __forceinline__ bool out_of_range(long long v) {
    return (unsigned long long)v + (unsigned long long)(RANGE - 1)
        > (unsigned long long)(2 * RANGE - 2);
}

// A form's taps: the window's samples W, the coefficients Q (as the
// table in shared memory holds them) and the sums A.  "i32": wrapping
// int32.  "f64" on int32 signals: float64 fma on integer-valued doubles,
// exact under lpc_residual's bound (|q x| <= 2^46, sums <= 2^51), so the
// sum converts to int64 exactly.  "f64" on int64 signals (the 33-bit
// side): exact int64 products.
// CHUNK: the candidates a pass down the taps, as many as their 4 sums
// each and their coefficients keep in registers without a spill.
template <typename X, bool F64> struct Taps;
template <> struct Taps<int, false> {
    using W = int; using Q = int; using A = unsigned;
    static constexpr int CHUNK = 5;
};
template <> struct Taps<int, true> {
    using W = double; using Q = double; using A = double;
    static constexpr int CHUNK = 4;
};
template <> struct Taps<long long, true> {
    using W = long long; using Q = int; using A = long long;
    static constexpr int CHUNK = 4;
};

// one tap of one sample into its sum
__device__ __forceinline__ void mac(unsigned& p, int q, int w) {
    p += (unsigned)q * (unsigned)w;
}
__device__ __forceinline__ void mac(double& p, double q, double w) {
    p = fma(q, w, p);
}
__device__ __forceinline__ void mac(long long& p, int q, long long w) {
    p += (long long)q * w;
}

// ---- PTX helpers ----
// copy 16 (or 4, 8) bytes from device memory into shared memory without
// registers, zero-filled past `bytes` (cp.async); a group a span, and a
// wait for all but the newest RING - 1 groups of this thread
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_one(int* dst, const int* src,
                                             int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_one(long long* dst,
                                             const long long* src,
                                             int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 1) : "memory");
}
// ---- end of PTX helpers ----

// 4 samples of the staged signal from xs[i] (i a multiple of 4)
__device__ __forceinline__ void load4(const int* xs, int i, int* w) {
    const int4 v = *reinterpret_cast<const int4*>(xs + i);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const long long* xs, int i,
                                      long long* w) {
    const longlong2 a = *reinterpret_cast<const longlong2*>(xs + i);
    const longlong2 b = *reinterpret_cast<const longlong2*>(xs + i + 2);
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}
__device__ __forceinline__ void load4(const double* xs, int i, double* w) {
    const double2 a = *reinterpret_cast<const double2*>(xs + i);
    const double2 b = *reinterpret_cast<const double2*>(xs + i + 2);
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// 4 residuals of one row at n0..n0+3 (those below N)
__device__ __forceinline__ void store4(int* row, int n0, int N, bool vec,
                                       const int* v) {
    if (vec) {
        *reinterpret_cast<int4*>(row + n0) = make_int4(v[0], v[1], v[2],
                                                       v[3]);
    } else {
        row[n0] = v[0];
        if (n0 + 1 < N) row[n0 + 1] = v[1];
        if (n0 + 2 < N) row[n0 + 2] = v[2];
        if (n0 + 3 < N) row[n0 + 3] = v[3];
    }
}

// The CTA's shared memory: a ring of spans, each with its history, the
// coefficient table of one block of candidates, the block's flags and
// the slots rank 0 gathers the cluster's flags in (two, by block parity,
// so that one cluster barrier a block suffices)
template <typename X, bool F64>
struct Smem {
    alignas(16) X xs[RING][HALO + SPAN];
    alignas(16) typename Taps<X, F64>::Q qs[BLOCK][MAX_ORDER];
    int order[BLOCK], shift[BLOCK], taps[BLOCK];
    unsigned long long bad;               // bit b: row b of the block
    unsigned slot[2][CLUSTER][2];
};

// start copying span sp of row x into xs (zeros outside 0..N-1):
// 16-byte copies where the row allows them, one sample each at its
// edges
template <typename X>
__device__ __forceinline__ void stage(X* xs, const X* x, int sp, int N,
                                      bool xvec) {
    constexpr int E = 16 / sizeof(X);        // samples a 16-byte copy
    const int s0 = sp * SPAN - HALO;
    for (int c = threadIdx.x; c < (HALO + SPAN) / E; c += THREADS) {
        const int n = s0 + c * E;
        if (xvec && n >= 0 && n + E <= N) {
            cp_async16(xs + c * E, x + n, 16);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const bool in = n + e >= 0 && n + e < N;
                cp_async_one(xs + c * E + e, x + (in ? n + e : 0),
                             in ? (int)sizeof(X) : 0);
            }
        }
    }
}

// NC LPC candidates (block indices c0..c0+NC-1) at the thread's samples
// n0..n0+3 (xs index base): the taps, then each candidate's residuals,
// range flags (bit FIXED + c of `bad`) and store
template <int NC, typename X, bool F64>
__device__ __forceinline__ void lpc_chunk(const Smem<X, F64>& sm,
                                          const X* xs, int c0, int base,
                                          int n0, int N, bool vec, int* rows,
                                          unsigned long long& bad) {
    using W = typename Taps<X, F64>::W;
    using Q = typename Taps<X, F64>::Q;
    using A = typename Taps<X, F64>::A;
    A acc[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[c][k] = 0;
    int taps = 0, top = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        taps = max(taps, sm.taps[c0 + c]);
        top = max(top, sm.order[c0 + c]);
    }
    X own[4];
    W hi[4];
    load4(xs, base, own);
#pragma unroll
    for (int k = 0; k < 4; ++k) hi[k] = (W)own[k];
    // taps 4g .. 4g + 3: w[p] = x[n0 - 4g - 4 + p], so tap 4g + i of
    // sample n0 + k is w[k + 3 - i]
    for (int g = 0; 4 * g < taps; ++g) {
        X lo[4];
        load4(xs, base - 4 - 4 * g, lo);
        W w[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            w[k] = (W)lo[k];
            w[4 + k] = hi[k];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            Q q[4];
            load4(sm.qs[c0 + c], 4 * g, q);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) mac(acc[c][k], q[i], w[k + 3 - i]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) hi[k] = w[k];
    }
    // the residuals: no mask where every sample is past every order and
    // below N
    const bool inner = n0 >= top && n0 + 3 < N;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int order = sm.order[c0 + c];
        int v[4];
        if constexpr (F64) {
            const int sh = clamp_shift(sm.shift[c0 + c], 64);
            bool out = false;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const long long e = (long long)own[k]
                    - ((long long)acc[c][k] >> sh);
                const bool live = inner || (n0 + k >= order && n0 + k < N);
                out |= live && out_of_range(e);
                v[k] = live ? (int)(unsigned long long)e : 0;
            }
            if (out) bad |= 1ull << (FIXED + c0 + c);
        } else {
            const int sh = clamp_shift(sm.shift[c0 + c], 32);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = (int)((unsigned)own[k]
                                    - (unsigned)((int)acc[c][k] >> sh));
                const bool live = inner || (n0 + k >= order && n0 + k < N);
                v[k] = live ? e : 0;
            }
        }
        store4(rows + (size_t)c * N, n0, N, vec, v);
    }
}

// lpc_chunk<nc> for a chunk of nc <= NC candidates
template <int NC, typename X, bool F64>
__device__ __forceinline__ void lpc_chunks(int nc, const Smem<X, F64>& sm,
                                           const X* xs, int c0, int base,
                                           int n0, int N, bool vec,
                                           int* rows,
                                           unsigned long long& bad) {
    if constexpr (NC > 1) {
        if (nc < NC) {
            lpc_chunks<NC - 1, X, F64>(nc, sm, xs, c0, base, n0, N, vec,
                                       rows, bad);
            return;
        }
    }
    lpc_chunk<NC, X, F64>(sm, xs, c0, base, n0, N, vec, rows, bad);
}

// the fixed orders 0..4 at the thread's samples n0..n0+3: the o-th
// difference of the window x[n0 - 4 .. n0 + 3], order o's in w[4..7]
// after step o; wide rows exact in int64 with their range flags (bits
// 0..4 of `bad`), narrow rows wrapping
template <typename X, bool WIDE>
__device__ __forceinline__ void fixed_rows(const X* xs, int base, int n0,
                                           int N, bool vec, int* res_r,
                                           unsigned long long& bad) {
    using T = typename std::conditional<WIDE, long long, unsigned>::type;
    X lo[4], own[4];
    load4(xs, base - 4, lo);
    load4(xs, base, own);
    T w[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        w[k] = (T)lo[k];
        w[4 + k] = (T)own[k];
    }
    const bool inner = n0 >= FIXED - 1 && n0 + 3 < N;
#pragma unroll
    for (int o = 0; o < FIXED; ++o) {
        if (o > 0) {
#pragma unroll
            for (int i = 7; i >= o; --i) w[i] = w[i] - w[i - 1];
        }
        int v[4];
        bool out = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool live = inner || (n0 + k >= o && n0 + k < N);
            if constexpr (WIDE) out |= live && out_of_range(w[4 + k]);
            v[k] = live ? (int)(unsigned)w[4 + k] : 0;
        }
        if (out) bad |= 1ull << o;
        store4(res_r + (size_t)o * N, n0, N, vec, v);
    }
}

template <typename X, bool WIDE, bool F64>
__global__ void __launch_bounds__(THREADS)
candidate_residuals_kernel(const Args a) {
    constexpr bool FLAGS = WIDE || F64;
    __shared__ Smem<X, F64> sm;
    const int t = threadIdx.x;
    const int part = blockIdx.x;
    const int N = a.N, AC = a.AC, C = FIXED + AC;
    const int spans = (N + SPAN - 1) / SPAN;
    const int sp0 = part * a.spans_per_part;
    const int nsp = min(a.spans_per_part, spans - sp0);  // >= 1
    const int blocks = max(1, (AC + BLOCK - 1) / BLOCK);
    const bool vec = a.vec != 0, xvec = a.xvec != 0;
    const int base = HALO + t * PER_THREAD;  // xs index of the thread's n0
    // a cluster's CTAs arrive now and wait before the first store into
    // rank 0's shared memory: every CTA of the cluster is running by then
    const int rank = FLAGS ? cluster_rank() : 0;
    const int ranks = FLAGS ? cluster_size() : 1;
    bool started = ranks == 1;
    if (!started) cluster_arrive_relaxed();

    for (int r = blockIdx.y; r < a.R; r += gridDim.y) {
        const X* x = static_cast<const X*>(a.x) + (size_t)r * N;
        int* res_r = a.res + (size_t)r * C * N;
        for (int blk = 0; blk < blocks; ++blk) {
            const int cb = blk * BLOCK, nb = min(BLOCK, AC - cb);
            const size_t cand = (size_t)r * AC + cb;
            unsigned long long bad = 0;      // bit b: a residual past 2^31
            __syncthreads();                 // the last block is read
            // the first RING - 1 spans in flight, then the block's
            // coefficients, zero past each one's taps
            for (int i = 0; i < RING - 1; ++i) {
                if (i < nsp) stage(sm.xs[i], x, sp0 + i, N, xvec);
                cp_async_commit();
            }
            for (int i = t; i < nb * MAX_ORDER; i += THREADS) {
                const int c = i / MAX_ORDER, j = i % MAX_ORDER;
                const int q = a.qc[(cand + c) * MAX_ORDER + j];
                sm.qs[c][j] = j < min(a.order[cand + c], a.max_j) ? q : 0;
            }
            if (t < nb) {
                sm.order[t] = a.order[cand + t];
                sm.shift[t] = a.qshift[cand + t];
                sm.taps[t] = min(sm.order[t], a.max_j);
            }
            if (t == 0) sm.bad = 0;
            for (int i = 0; i < nsp; ++i) {
                // span i + RING - 1 into the buffer span i - 1 left
                if (i + RING - 1 < nsp)
                    stage(sm.xs[(i + RING - 1) % RING], x,
                          sp0 + i + RING - 1, N, xvec);
                cp_async_commit();
                cp_async_wait_ring();        // span i has landed
                __syncthreads();
                const X* xs = sm.xs[i % RING];
                const int n0 = (sp0 + i) * SPAN + t * PER_THREAD;
                if (n0 < N) {
                    if (blk == 0)
                        fixed_rows<X, WIDE>(xs, base, n0, N, vec, res_r,
                                            bad);
                    // the LPC candidates in chunks of up to CHUNK, as
                    // even as they go
                    constexpr int CHUNK = Taps<X, F64>::CHUNK;
                    const int chunks = (nb + CHUNK - 1) / CHUNK;
                    for (int k = 0, c0 = 0; k < chunks; ++k) {
                        const int nc = nb / chunks + (k < nb % chunks);
                        lpc_chunks<CHUNK, X, F64>(
                            nc, sm, xs, c0, base, n0, N, vec,
                            res_r + (size_t)(FIXED + cb + c0) * N, bad);
                        c0 += nc;
                    }
                }
                __syncthreads();             // span i's buffer is read
            }

            // the flags and the orders of the block
            if constexpr (FLAGS) {
                const unsigned lo = __reduce_or_sync(FULL, (unsigned)bad);
                const unsigned hi = __reduce_or_sync(FULL,
                                                     (unsigned)(bad >> 32));
                if ((t & 31) == 0 && (lo | hi))
                    atomicOr(&sm.bad, ((unsigned long long)hi << 32) | lo);
                __syncthreads();
                unsigned long long all = sm.bad;
                if (ranks > 1) {
                    if (!started) cluster_wait();
                    started = true;
                    if (t < 2)
                        store_remote(&sm.slot[blk & 1][rank][t], 0,
                                     (unsigned)(all >> (32 * t)));
                    cluster_barrier();
                    all = 0;
                    for (int i = 0; i < ranks; ++i)
                        all |= ((unsigned long long)sm.slot[blk & 1][i][1]
                                << 32) | sm.slot[blk & 1][i][0];
                }
                if (rank == 0) {
                    if (WIDE && blk == 0 && t < FIXED)
                        a.f_ok[(size_t)r * FIXED + t] = !((all >> t) & 1);
                    if (F64 && t >= FIXED && t < FIXED + nb)
                        a.fit_ok[cand + t - FIXED] = !((all >> t) & 1);
                }
            }
            if (part == 0) {
                if (!WIDE && blk == 0 && t < FIXED)
                    a.f_ok[(size_t)r * FIXED + t] = 1;
                if (blk == 0 && t < FIXED)
                    a.order_all[(size_t)r * C + t] = t;
                if (t < nb) {
                    if (!F64)
                        a.fit_ok[cand + t] = fits_i32(
                            a.qc + (cand + t) * MAX_ORDER, a.bps[r],
                            sm.shift[t]);
                    a.order_all[(size_t)r * C + FIXED + cb + t] =
                        sm.order[t];
                }
            }
        }
    }
}

// CTAs a row (at most CLUSTER, and one span each at least): as many as
// let R rows fill one wave of `slots` CTAs, halving from CLUSTER; then
// the spans of a CTA and the CTAs that take some
inline void grid_of(int R, int N, int slots, int* parts,
                    int* per_part) {
    const int spans = (N + SPAN - 1) / SPAN;
    int p = spans < CLUSTER ? spans : CLUSTER;
    while (p > 1 && (long long)R * p > slots) p = (p + 1) / 2;
    *per_part = (spans + p - 1) / p;
    *parts = (spans + *per_part - 1) / *per_part;
}

// the CTAs of a form's kernel the current device holds at once, and an
// SM, asked once a form and device (a key's first launch, before any
// graph capture)
template <typename X, bool WIDE, bool F64>
cudaError_t slots_of(int* slots) {
    const auto kernel = candidate_residuals_kernel<X, WIDE, F64>;
    constexpr int DEVICES = 64;
    static int sms[DEVICES], per_sm[DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= DEVICES) return cudaErrorInvalidDevice;
    if (per_sm[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[dev], kernel, THREADS, 0);
        if (e != cudaSuccess) return e;
    }
    slots[0] = sms[dev] * per_sm[dev];
    slots[1] = per_sm[dev];
    return cudaSuccess;
}

template <typename X, bool WIDE, bool F64>
int launch(Args a, cudaStream_t s, int* parts_out) {
    const auto kernel = candidate_residuals_kernel<X, WIDE, F64>;
    int slots[2];
    cudaError_t e = slots_of<X, WIDE, F64>(slots);
    if (e != cudaSuccess) return (int)e;
    int parts;
    grid_of(a.R, a.N, slots[0], &parts, &a.spans_per_part);
    if (parts_out) {
        parts_out[0] = parts;
        parts_out[1] = slots[1];
        return 0;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(parts, a.R < 65535 ? a.R : 65535, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = (WIDE || F64) && parts > 1 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int dispatch(const Args& a, int x64, int wide, int f64, cudaStream_t s,
             int* parts_out) {
    if (x64) return launch<long long, true, true>(a, s, parts_out);
    if (wide) return f64 ? launch<int, true, true>(a, s, parts_out)
                         : launch<int, true, false>(a, s, parts_out);
    return f64 ? launch<int, false, true>(a, s, parts_out)
               : launch<int, false, false>(a, s, parts_out);
}

}  // namespace

extern "C" {

// K8 on R = B * CH rows: x [R, N] (int32, or int64 with x64), qc [R, AC,
// 32], qshift and order [R, AC], bps [R] int32; res [R, 5 + AC, N] and
// order_all [R, 5 + AC] int32, f_ok [R, 5] and fit_ok [R, AC] bytes out,
// all device pointers; max_j the taps' bound (lpc_residual's), wide the
// fixed path, f64 the LPC mode.  A row takes up to CLUSTER CTAs, each a
// run of its spans (a cluster where its flags are ORed over them: wide
// or f64).  Returns the CUDA error code of the launch (0 on success).
int flac_candidate_residuals(const void* x, const void* qc,
                             const void* qshift, const void* order,
                             const void* bps, void* res, void* order_all,
                             void* f_ok, void* fit_ok, int R, int AC, int N,
                             int max_j, int x64, int wide, int f64,
                             void* stream) {
    if (R <= 0) return 0;
    if (N < 1 || AC < 0 || max_j < 1 || max_j > MAX_ORDER
            || (x64 && !(wide && f64)))
        return (int)cudaErrorInvalidValue;
    const int xbytes = x64 ? 8 : 4;
    Args a{x, (const int*)qc, (const int*)qshift, (const int*)order,
           (const int*)bps, (int*)res, (int*)order_all,
           (unsigned char*)f_ok, (unsigned char*)fit_ok, R, AC, N, max_j,
           (int)(N % 4 == 0 && ((uintptr_t)res & 15) == 0),
           (int)((N * xbytes) % 16 == 0 && ((uintptr_t)x & 15) == 0), 0};
    return dispatch(a, x64, wide, f64, (cudaStream_t)stream, nullptr);
}

// The grid flac_candidate_residuals launches for these R, N and form on
// the current device: out[0] the CTAs a row, out[1] the CTAs an SM holds
// (the occupancy that sizes it).  Returns a CUDA error code.
int flac_candidate_residuals_grid(int R, int N, int x64, int wide, int f64,
                                  int* out) {
    Args a{};
    a.R = R;
    a.N = N;
    return dispatch(a, x64, wide, f64, nullptr, out);
}

}  // extern "C"
