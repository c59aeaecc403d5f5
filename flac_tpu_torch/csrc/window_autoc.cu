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
// (__int2float_rn or __ll2float_rn, then __fmul_rn).  Column t of 128 (a
// thread) sums its blocks' products in ascending order, each step
// p = __fmaf_rn(d[n], d[n + l], p), rounded once to float32 (the plain
// version emulates that fused rounding exactly in float64: _fma_float32).
// A product past N is an exact zero, which leaves p as it is.  The 128
// columns meet in a fixed float64 tree: the halves of each warp (lane
// j + 16, j + 8, ... by __shfl_down_sync), then the halves of the 4 warp
// sums.  The combine adds combine[a, w] * autoc_w (__dmul_rn,
// then __dadd_rn, never contracted) in ascending w, from 0.
//
// Design (Hopper): a CTA of 128 threads (a thread a Gram column) a row.
// The row is staged in shared memory as float32 a tile of TILE samples
// and an O-sample halo at a time, with 16-byte loads (once for the main
// path's 4096-sample frames, whatever the windows); each window's samples
// are formed beside it, from the window's row read with 16-byte loads;
// thread t's accumulators, one a lag up to a template bound (8, 12 or 32:
// -5, -8, the rest), stay in registers, a float32 fma a step.  A window's
// lags are reduced, then its combine rows are added into the output in
// device memory by the thread of that lag.  The bound at -8 is the fmas
// (82 M a 64-frame call: ~2.4 us at the H100's 67 TFLOP/s of float32
// outside the tensor cores), at -5 the bytes (x read once, 4.2 MB: ~1.3
// us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;            // a thread a Gram column
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;              // samples a staged tile
constexpr int HALO = 32;                // the largest lag
constexpr int BLOCKS = TILE / THREADS;  // Gram blocks a tile
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
    const void* x;                      // [R, N] int32 or int64
    const float* windows;               // [W, N]
    const double* combine;              // [A, W]
    double* out;                        // [R, A, O + 1]
    int N, W, A, O;
    int vec;                            // 16-byte loads (N % 4 == 0, aligned)
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(long long v) {
    return __ll2float_rn(v);
}

// four samples of x from p (16-byte aligned), as float32
__device__ __forceinline__ float4 load4(const int* p) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    return make_float4(to_float(q.x), to_float(q.y), to_float(q.z),
                       to_float(q.w));
}
__device__ __forceinline__ float4 load4(const long long* p) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
    return make_float4(to_float(a.x), to_float(a.y), to_float(b.x),
                       to_float(b.y));
}

// s[i] = float32(x[base + i]) for i < span, zero to TILE + HALO
template <typename X>
__device__ __forceinline__ void stage_row(float* s, const X* x, int base,
                                          int span, bool vec, int t) {
    if (vec) {                          // span and base are multiples of 4
#pragma unroll
        for (int i = 4 * t; i < TILE + HALO; i += 4 * THREADS)
            *reinterpret_cast<float4*>(s + i) = i < span
                ? load4(x + base + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
        for (int i = t; i < TILE + HALO; i += THREADS)
            s[i] = i < span ? to_float(x[base + i]) : 0.0f;
    }
}

// d[i] = s[i] * win[base + i] rounded to float32 for i < span, zero past
__device__ __forceinline__ void stage_window(float* d, const float* s,
                                             const float* win, int base,
                                             int span, bool vec, int t) {
    if (vec) {
#pragma unroll
        for (int i = 4 * t; i < TILE + HALO; i += 4 * THREADS) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < span) {
                const float4 xv = *reinterpret_cast<const float4*>(s + i);
                const float4 wv = __ldg(reinterpret_cast<const float4*>(
                    win + base + i));
                v = make_float4(__fmul_rn(xv.x, wv.x), __fmul_rn(xv.y, wv.y),
                                __fmul_rn(xv.z, wv.z), __fmul_rn(xv.w, wv.w));
            }
            *reinterpret_cast<float4*>(d + i) = v;
        }
    } else {
        for (int i = t; i < TILE + HALO; i += THREADS)
            d[i] = i < span ? __fmul_rn(s[i], win[base + i]) : 0.0f;
    }
}

// MAXLAG: the template's largest lag (O <= MAXLAG)
template <typename X, int MAXLAG>
__global__ void __launch_bounds__(THREADS)
window_autoc_kernel(const Args a) {
    __shared__ __align__(16) float s_x[TILE + HALO];    // the row's tile
    __shared__ __align__(16) float s_d[TILE + HALO];    // a window's samples
    __shared__ double s_warp[WARPS][MAXLAG + 1];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int r = blockIdx.x;
    const int N = a.N, O = a.O, L1 = O + 1;
    const bool vec = a.vec;
    const X* x = static_cast<const X*>(a.x) + (size_t)r * N;
    const int tiles = (N + TILE - 1) / TILE;
    double* out = a.out + (size_t)r * a.A * L1;

    // one tile holds the row: staged once for every window
    if (tiles == 1) stage_row(s_x, x, 0, N, vec, t);
    for (int w = 0; w < a.W; ++w) {
        const float* win = a.windows + (size_t)w * N;
        float acc[MAXLAG + 1];
#pragma unroll
        for (int l = 0; l <= MAXLAG; ++l) acc[l] = 0.0f;
        for (int tile = 0; tile < tiles; ++tile) {
            const int base = tile * TILE;
            const int span = min(TILE + O, N - base);   // samples < N
            __syncthreads();                  // the last tile's reads done
            if (tiles > 1) {
                stage_row(s_x, x, base, span, vec, t);
                __syncthreads();
            }
            stage_window(s_d, s_x, win, base, span, vec, t);
            __syncthreads();
            for (int k = 0; k < BLOCKS; ++k) {
                const int i = k * THREADS + t;
                if (base + i >= N) break;
                const float d0 = s_d[i];
#pragma unroll
                for (int l = 0; l <= MAXLAG; ++l)
                    if (l <= O) acc[l] = __fmaf_rn(d0, s_d[i + l], acc[l]);
            }
        }
        // the tree: each warp's halves, then the warps' halves
#pragma unroll
        for (int l = 0; l <= MAXLAG; ++l) {
            if (l > O) break;
            double v = acc[l];                 // the tree in float64
#pragma unroll
            for (int h = 16; h > 0; h >>= 1) v += __shfl_down_sync(FULL, v, h);
            if (lane == 0) s_warp[warp][l] = v;
        }
        __syncthreads();
        if (t < L1) {
            double p[WARPS];
#pragma unroll
            for (int j = 0; j < WARPS; ++j) p[j] = s_warp[j][t];
#pragma unroll
            for (int h = WARPS / 2; h > 0; h >>= 1)
#pragma unroll
                for (int j = 0; j < h; ++j) p[j] = p[j] + p[j + h];
            // the combine, in ascending w: out[a] = out[a] + c[a, w] * p
            for (int ai = 0; ai < a.A; ++ai) {
                double* o = out + (size_t)ai * L1 + t;
                const double prev = w == 0 ? 0.0 : *o;
                *o = __dadd_rn(prev, __dmul_rn(a.combine[(size_t)ai * a.W + w],
                                               p[0]));
            }
        }
    }
}

template <typename X>
int launch(const Args& a, cudaStream_t s, int R) {
    if (a.O <= 8) window_autoc_kernel<X, 8><<<R, THREADS, 0, s>>>(a);
    else if (a.O <= 12) window_autoc_kernel<X, 12><<<R, THREADS, 0, s>>>(a);
    else window_autoc_kernel<X, 32><<<R, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
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
    if (N < 2 || W < 1 || O < 1 || O > HALO || O >= N)
        return (int)cudaErrorInvalidValue;
    const Args a{x, (const float*)windows, (const double*)combine,
                 (double*)out, N, W, A, O,
                 (int)(N % 4 == 0 && ((uintptr_t)x & 15) == 0
                       && ((uintptr_t)windows & 15) == 0)};
    const cudaStream_t s = (cudaStream_t)stream;
    return x64 ? launch<long long>(a, s, R) : launch<int>(a, s, R);
}

}  // extern "C"
