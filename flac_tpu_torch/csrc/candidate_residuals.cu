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
// of two.  Wide fixed rows and the "f64" mode run in int64, exact where
// the plain version's float64 is (products <= 2^47, sums <= 2^52), so
// floor(pred 2^-shift) is an arithmetic right shift; their flag is
// max |res| < 2^31 over the masked row, a CTA reduction.  On a row whose
// flag is false the plain version's cast of an out-of-range double has no
// defined value; K8 writes the low 32 bits there.  The taps stop at the
// smaller of the candidate's order and max_j (lpc_residual's loop bound):
// qc is zero past the order, as the quantizer writes it.
//
// Design (Hopper): a CTA of 256 threads a (row, candidate group): group 0
// the five fixed orders, group g >= 1 the LPC candidates 4 (g - 1) ..
// 4 g - 1, so -5 (one LPC candidate) runs 2 CTAs a row and -8 (nine) 4.
// The CTA stages x through shared memory in tiles of 1024 samples with the
// 32 samples before each tile (the longest history), coalesced; its
// candidates' coefficients, shifts and orders sit in shared memory.  A
// thread takes 4 consecutive samples: the fixed orders are differences of
// its 8-sample window in registers, an LPC candidate slides its window
// down the taps (one shared load and 4 multiply-adds a tap); each row's 4
// residuals go out as one 16-byte store (scalar where N % 4 != 0).  The
// bound is bytes: x read once and res written once (25 MB at -5).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;           // threads a CTA
constexpr int PER_THREAD = 4;          // consecutive samples a thread
constexpr int TILE = THREADS * PER_THREAD;   // samples a tile
constexpr int HALO = 32;               // format.MAX_LPC_ORDER: history
constexpr int GROUP = 4;               // LPC candidates a CTA
constexpr int FIXED = 5;               // fixed orders 0..4
constexpr int MAX_ORDER = 32;          // coefficients a candidate
constexpr long long RANGE = 1LL << 31;

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
};

// exact 2.0**e (ops/lpc.py _pow2: the table of 2^-1075 .. 2^1024)
__device__ __forceinline__ double pow2(int e) {
    if (e <= -1075) return 0.0;
    if (e >= 1024) return __longlong_as_double(0x7FF0000000000000LL);
    if (e >= -1022) return __longlong_as_double((long long)(e + 1023) << 52);
    return __longlong_as_double(1LL << (e + 1074));
}

// lpc_residual's "i32" range analysis in float64: sum |q| (torch's int32
// abs, which leaves -2^31 as it is) times 2^(bps-1) and the residual
// bound 2^(bps-1) + floor(that 2^-shift), both below 2^31
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

// torch's >> of an int32 by an int32 amount (a shift past 31, or below
// 0, fills with the sign)
__device__ __forceinline__ int shr32(int v, int s) {
    return v >> ((s < 0 || s > 31) ? 31 : s);
}

__device__ __forceinline__ long long shr64(long long v, int s) {
    return v >> ((s < 0 || s > 63) ? 63 : s);
}

__device__ __forceinline__ bool out_of_range(long long v) {
    return v >= RANGE || v <= -RANGE;
}

// 4 residuals of one row at n0..n0+3 (those below N)
__device__ __forceinline__ void store4(int* row, int n0, int N, bool vec,
                                       int r0, int r1, int r2, int r3) {
    if (vec) {
        *reinterpret_cast<int4*>(row + n0) = make_int4(r0, r1, r2, r3);
    } else {
        row[n0] = r0;
        if (n0 + 1 < N) row[n0 + 1] = r1;
        if (n0 + 2 < N) row[n0 + 2] = r2;
        if (n0 + 3 < N) row[n0 + 3] = r3;
    }
}

template <typename X, bool WIDE, bool F64>
__global__ void __launch_bounds__(THREADS)
candidate_residuals_kernel(const Args a) {
    __shared__ X xs[HALO + TILE];
    __shared__ int qs[GROUP][MAX_ORDER];
    __shared__ int s_order[GROUP], s_shift[GROUP];
    const int t = threadIdx.x;
    const int r = blockIdx.x;
    const int g = blockIdx.y;
    const int N = a.N;
    const int C = FIXED + a.AC;
    const X* x = static_cast<const X*>(a.x) + (size_t)r * N;
    int* res_r = a.res + (size_t)r * C * N;
    const bool vec = a.vec != 0;

    // the CTA's candidates
    const int c0 = (g - 1) * GROUP;
    const int nc = g == 0 ? FIXED : min(GROUP, a.AC - c0);
    if (g > 0) {
        const size_t cand = (size_t)r * a.AC + c0;
        if (t < nc * MAX_ORDER)
            qs[t / MAX_ORDER][t % MAX_ORDER] = a.qc[cand * MAX_ORDER + t];
        if (t < nc) {
            s_order[t] = a.order[cand + t];
            s_shift[t] = a.qshift[cand + t];
        }
    }
    unsigned bad = 0;          // bit c: a residual of candidate c past 2^31

    for (int t0 = 0; t0 < N; t0 += TILE) {
        __syncthreads();                     // the last tile is read
        for (int i = t; i < HALO + TILE; i += THREADS) {
            const int n = t0 - HALO + i;
            xs[i] = (n >= 0 && n < N) ? x[n] : X(0);
        }
        __syncthreads();
        const int n0 = t0 + t * PER_THREAD;
        if (n0 >= N) continue;
        const int base = HALO + t * PER_THREAD;   // xs index of n0
        if (g == 0) {
            // fixed order o: the o-th difference, from the window
            // x[n0 - 4 .. n0 + 3]; order o's rows in w[4..7] after step o
            using T = typename std::conditional<WIDE, long long,
                                                unsigned>::type;
            T w[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) w[i] = (T)xs[base - 4 + i];
#pragma unroll
            for (int o = 0; o < FIXED; ++o) {
                if (o > 0) {
#pragma unroll
                    for (int i = 7; i >= o; --i) w[i] = w[i] - w[i - 1];
                }
                int v[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool live = n0 + k >= o && n0 + k < N;
                    if constexpr (WIDE) {
                        if (live && out_of_range(w[4 + k])) bad |= 1u << o;
                    }
                    v[k] = live ? (int)(unsigned)w[4 + k] : 0;
                }
                store4(res_r + (size_t)o * N, n0, N, vec, v[0], v[1], v[2],
                       v[3]);
            }
        } else {
            using T = typename std::conditional<F64, long long,
                                                unsigned>::type;
            for (int c = 0; c < nc; ++c) {
                const int order = s_order[c];
                const int taps = min(order, a.max_j);
                // window w[k] = x[n0 + k - 1 - j] at tap j
                T w0 = (T)xs[base], w1 = (T)xs[base + 1],
                  w2 = (T)xs[base + 2], w3 = 0;
                T p0 = 0, p1 = 0, p2 = 0, p3 = 0;
                for (int j = 0; j < taps; ++j) {
                    w3 = w2; w2 = w1; w1 = w0;
                    w0 = (T)xs[base - 1 - j];
                    const T q = (T)qs[c][j];
                    p0 += q * w0; p1 += q * w1; p2 += q * w2; p3 += q * w3;
                }
                const T p[4] = {p0, p1, p2, p3};
                const int sh = s_shift[c];
                int v[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool live = n0 + k >= order && n0 + k < N;
                    const X xn = xs[base + k];
                    if constexpr (F64) {
                        const long long e = (long long)xn
                            - shr64((long long)p[k], sh);
                        if (live && out_of_range(e)) bad |= 1u << c;
                        v[k] = live ? (int)(unsigned long long)e : 0;
                    } else {
                        const int e = (int)((unsigned)xn - (unsigned)shr32(
                            (int)(unsigned)p[k], sh));
                        v[k] = live ? e : 0;
                    }
                }
                store4(res_r + (size_t)(FIXED + c0 + c) * N, n0, N, vec,
                       v[0], v[1], v[2], v[3]);
            }
        }
    }

    // the flags (a CTA reduction each) and the orders
    if (g == 0) {
        for (int o = 0; o < FIXED; ++o) {
            const int any = __syncthreads_or(WIDE ? (bad >> o) & 1u : 0u);
            if (t == 0) a.f_ok[(size_t)r * FIXED + o] = !any;
        }
        if (t < FIXED) a.order_all[(size_t)r * C + t] = t;
    } else {
        for (int c = 0; c < nc; ++c) {
            const int any = __syncthreads_or(F64 ? (bad >> c) & 1u : 0u);
            if (t == c) {
                const bool ok = F64 ? !any
                    : fits_i32(qs[c], a.bps[r], s_shift[c]);
                a.fit_ok[(size_t)r * a.AC + c0 + c] = ok;
                a.order_all[(size_t)r * C + FIXED + c0 + c] = s_order[c];
            }
        }
    }
}

template <typename X, bool WIDE, bool F64>
int launch(const Args& a, cudaStream_t s) {
    const dim3 grid(a.R, 1 + (a.AC + GROUP - 1) / GROUP);
    candidate_residuals_kernel<X, WIDE, F64><<<grid, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8 on R = B * CH rows: x [R, N] (int32, or int64 with x64), qc [R, AC,
// 32], qshift and order [R, AC], bps [R] int32; res [R, 5 + AC, N] and
// order_all [R, 5 + AC] int32, f_ok [R, 5] and fit_ok [R, AC] bytes out,
// all device pointers; max_j the taps' bound (lpc_residual's), wide the
// fixed path, f64 the LPC mode.  Returns the CUDA error code of the launch
// (0 on success).
int flac_candidate_residuals(const void* x, const void* qc,
                             const void* qshift, const void* order,
                             const void* bps, void* res, void* order_all,
                             void* f_ok, void* fit_ok, int R, int AC, int N,
                             int max_j, int x64, int wide, int f64,
                             void* stream) {
    if (R <= 0) return 0;
    if (N < 1 || AC < 0 || max_j < 1 || max_j > MAX_ORDER
            || (AC + GROUP - 1) / GROUP + 1 > 65535
            || (x64 && !(wide && f64)))
        return (int)cudaErrorInvalidValue;
    Args a{x, (const int*)qc, (const int*)qshift, (const int*)order,
           (const int*)bps, (int*)res, (int*)order_all,
           (unsigned char*)f_ok, (unsigned char*)fit_ok, R, AC, N, max_j,
           (int)(N % 4 == 0 && ((uintptr_t)res & 15) == 0)};
    const cudaStream_t s = (cudaStream_t)stream;
    if (x64) return launch<long long, true, true>(a, s);
    if (wide) return f64 ? launch<int, true, true>(a, s)
                         : launch<int, true, false>(a, s);
    return f64 ? launch<int, false, true>(a, s)
               : launch<int, false, false>(a, s);
}

}  // extern "C"
