// LPC restore, wasted-bit shift and stereo undo of the decoders (kernel K3
// of flac_tpu_torch).
//
// Replaces flac_tpu/ops/bitunpack.py:53-120, restore_undo_body: an XLA
// lax.scan over the samples of every subframe of a batch, which both the
// device engine (after the code scan) and the "fast" engine (after the
// native full parse) run as one compiled program.  Same contract as its
// plain version, flac_tpu_torch/ops/bitunpack.py restore_undo_body:
//
//   res   [S, >= N] residuals, int16, int32 or int64 (row stride rstride)
//   order, shift, wasted [S] int32; qlp [S, MO] int32 (MO >= 1); asg [B]
//   int32
//   -> pcm [B, C, N] (int16 with out16, else int32, int64 when wide),
//      oor [B] bool (stream_decoder.c:2458-2472's bps-range check, taken
//      before any narrowing; the caller zeroes it, bps = 0 disables it)
//
// Per subframe s and sample n (lpc.c:978 restore, S = B * C):
//   x[n] = r[n]                                   for n < order[s]
//   x[n] = r[n] + ((sum_i qlp[s,i] * x[n-1-i]) >> shift[s])   otherwise
// with the sum in int64 and x in int32 (wrapping) for narrow batches, in
// int64 for wide ones; then x << wasted[s] in the sample type; then, for
// C == 2, the stereo undo of stream_decoder.c:3476-3526 (assignment 1
// left/side, 2 right/side, 3 mid/side with mid = (a << 1) | (b & 1) and an
// arithmetic >> 1); then the range flag; then the narrowing to int16.
// Shifts follow PyTorch's rule, which the plain version obeys: a left shift
// by a negative amount or by the width or more gives 0, such a right shift
// gives the sign.  Signed overflow is undefined in C++, so every wrapping
// sum, product and left shift is done in the unsigned type (a narrow
// batch's sum of int32 products cannot overflow int64).
//
// Design for Hopper: the recursion is serial within a subframe and the
// >> makes it non-linear, so there is no parallel scan; one thread runs
// one subframe.  Its taps and its history live in registers: the kernel is
// a template on the order bucket MO (1, 2, 4, 8, 12, 16, 32, as the
// decoders' order buckets; a batch without taps runs MO 1 with a zero
// tap), so every history index is a constant (a runtime-indexed array
// would go to local memory).  A frame's channels sit
// in adjacent lanes of one warp (s = frame * C + channel, CTAs of one warp),
// so the stereo undo swaps a sample with the partner lane by
// __shfl_xor_sync, a group's shuffles back to back after its recursion;
// every lane of a warp runs the same sample loop, live or not, so the
// shuffles are always convergent.  A thread that finds a sample
// out of range stores 1 to its frame's flag (any number of channels, in
// any warp).  Residuals come in groups of GROUP samples, loaded one group
// ahead of the arithmetic (16-byte loads where rows are aligned), and the
// outputs leave in groups (16-byte stores where aligned).
//
// Bound on an H100: a full -5 batch (1024 stereo frames of 4096 samples,
// S = 2048) reads res once (33.5 MB in int32) and writes pcm once
// (16.8 MB in int16): ~50 MB, ~0.015 ms at 3.35 TB/s; its ~2 * order + 6
// integer operations a sample stay under that.  2048 threads are about 16
// warps on 132 SMs, so the kernel is latency-bound: each thread's serial
// chain of 4096 samples (a multiply-add, a shift and an add per sample on
// the newest history value) sets its time, not device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 32;     // subframes a CTA: one warp
constexpr int GROUP = 8;        // samples a load/store group
static_assert(GROUP == 8, "load_group and store_group move 8 samples");
constexpr int ASG_LEFT_SIDE = 1;
constexpr int ASG_RIGHT_SIDE = 2;
constexpr int ASG_MID_SIDE = 3;

// a * b + c for int32 factors in one IMAD.WIDE (nvcc otherwise widens both
// factors to 64 bits and multiplies 64 x 64, about five instructions)
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
#if defined(__CUDA_ARCH__)
    long long d;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
    return d;
#else
    return (long long)a * b + c;
#endif
}

// One residual as the sample type (int16 sign-extends, int64 truncates to
// int32 for narrow batches, as .to() does).
template <typename XT>
__device__ __forceinline__ XT load_one(const char* row, int rbytes, int n) {
    if (rbytes == 2) return (XT)__ldg((const short*)row + n);
    if (rbytes == 4) return (XT)__ldg((const int*)row + n);
    return (XT)__ldg((const long long*)row + n);
}

// The GROUP residuals from sample n0 of a row: 16-byte loads when `vec`
// (the row and n0 16-byte aligned, n0 + GROUP <= N), else one at a time
// with samples past N read as 0.
template <typename XT>
__device__ __forceinline__ void load_group(XT (&r)[GROUP], const char* row,
                                           int rbytes, int n0, int N,
                                           bool vec, bool live) {
    if (!live) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) r[u] = 0;
        return;
    }
    if (vec) {
        const uint4* p = (const uint4*)(row + (size_t)n0 * rbytes);
        if (rbytes == 2) {
            const uint4 v = __ldg(p);
            const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                r[2 * k] = (XT)(short)(w[k] & 0xFFFFu);
                r[2 * k + 1] = (XT)(short)(w[k] >> 16);
            }
        } else if (rbytes == 4) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const uint4 v = __ldg(p + k);
                r[4 * k] = (XT)(int)v.x;
                r[4 * k + 1] = (XT)(int)v.y;
                r[4 * k + 2] = (XT)(int)v.z;
                r[4 * k + 3] = (XT)(int)v.w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint4 v = __ldg(p + k);
                r[2 * k] = (XT)(long long)(((unsigned long long)v.y << 32) |
                                           v.x);
                r[2 * k + 1] =
                    (XT)(long long)(((unsigned long long)v.w << 32) | v.z);
            }
        }
        return;
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u)
        r[u] = n0 + u < N ? load_one<XT>(row, rbytes, n0 + u) : (XT)0;
}

// The group's outputs from sample n0 of a row, in int16 (out16) or the
// sample type: 16-byte stores when `vec`, else one at a time below N.
template <typename XT>
__device__ __forceinline__ void store_group(const XT (&y)[GROUP], char* row,
                                            bool out16, int n0, int N,
                                            bool vec) {
    if (out16) {
        if (vec) {
            unsigned int w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                w[k] = ((unsigned int)y[2 * k] & 0xFFFFu) |
                       ((unsigned int)y[2 * k + 1] << 16);
            *(uint4*)(row + (size_t)n0 * 2) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
            return;
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
            if (n0 + u < N) ((short*)row)[n0 + u] = (short)y[u];
        return;
    }
    if (vec) {
        uint4* p = (uint4*)(row + (size_t)n0 * sizeof(XT));
        if (sizeof(XT) == 4) {
#pragma unroll
            for (int k = 0; k < 2; ++k)
                p[k] = make_uint4((unsigned)y[4 * k], (unsigned)y[4 * k + 1],
                                  (unsigned)y[4 * k + 2],
                                  (unsigned)y[4 * k + 3]);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const unsigned long long a = (unsigned long long)y[2 * k];
                const unsigned long long b =
                    (unsigned long long)y[2 * k + 1];
                p[k] = make_uint4((unsigned)a, (unsigned)(a >> 32),
                                  (unsigned)b, (unsigned)(b >> 32));
            }
        }
        return;
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u)
        if (n0 + u < N) ((XT*)row)[n0 + u] = y[u];
}

template <int MO, bool WIDE>
__global__ void __launch_bounds__(THREADS)
restore_kernel(const char* __restrict__ res, int rbytes, long long rstride,
               bool vec_in, const int* __restrict__ order,
               const int* __restrict__ shift, const int* __restrict__ qlp,
               const int* __restrict__ wasted, const int* __restrict__ asg,
               char* __restrict__ pcm, bool out16, bool vec_out,
               unsigned char* __restrict__ oor, int S, int N, int C,
               int bps) {
    using XT = typename std::conditional<WIDE, long long, int>::type;
    using UT = typename std::make_unsigned<XT>::type;
    const int s = blockIdx.x * THREADS + threadIdx.x;
    const bool live = s < S;
    const int frame = live ? s / C : 0;
    const int ch = live ? s - frame * C : 0;
    const int ord = live ? order[s] : 0;
    const int sh = live ? shift[s] : 0;
    const int w = live ? wasted[s] : 0;
    const int a = (live && C == 2) ? asg[frame] : 0;
    int q[MO];
    XT h[MO];                   // h[i] = x[n-1-i]
#pragma unroll
    for (int i = 0; i < MO; ++i) {
        q[i] = live ? qlp[(size_t)s * MO + i] : 0;
        h[i] = 0;
    }
    // PyTorch's shifts, with their per-thread constants hoisted out of the
    // sample loop: >> by a shift below 0 or at 64 or more gives the sign
    // (a shift by 63); << below 0 or at the width or more gives 0 (wmask)
    constexpr int BITS = 8 * (int)sizeof(XT);
    const int sh_eff = (sh < 0 || sh >= 64) ? 63 : sh;
    const int w_eff = w & (BITS - 1);
    const UT wmask = (w < 0 || w >= BITS) ? (UT)0 : ~(UT)0;
    // the range check in the sample type: a narrow sample is never out of
    // the 32-bit range
    const unsigned check = (bps > 0 && (WIDE || bps < 32)) ? 1u : 0u;
    const XT lim = check ? (XT)(1LL << (bps - 1)) : (XT)0;
    unsigned bad = 0;
    const char* rrow = res + (size_t)(live ? s : 0) * rstride * rbytes;
    char* orow = pcm + (size_t)(live ? s : 0) * N *
                           (out16 ? 2 : (int)sizeof(XT));

    XT cur[GROUP];
    load_group<XT>(cur, rrow, rbytes, 0, N, vec_in, live);
    for (int n0 = 0; n0 < N; n0 += GROUP) {
        XT nxt[GROUP];          // the next group, in flight meanwhile
        load_group<XT>(nxt, rrow, rbytes, n0 + GROUP, N,
                       vec_in && n0 + GROUP < N, live && n0 + GROUP < N);
        XT y[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
            XT x = cur[u];
            // oldest terms first: the newest, x[n-1], joins last, so the
            // serial chain is one multiply-add, a shift, an add
            long long acc = 0;
#pragma unroll
            for (int i = MO - 1; i >= 0; --i) {
                if (WIDE)
                    acc = (long long)((unsigned long long)acc +
                                      (unsigned long long)(long long)q[i] *
                                          (unsigned long long)h[i]);
                else
                    acc = mad_wide(q[i], (int)h[i], acc);
            }
            const XT p = (XT)(acc >> sh_eff);
            if (n0 + u >= ord) x = (XT)((UT)x + (UT)p);
#pragma unroll
            for (int i = MO - 1; i > 0; --i) h[i] = h[i - 1];
            h[0] = x;
            y[u] = (XT)(((UT)x << w_eff) & wmask);
        }
        if (C == 2) {
            // after the group's recursion, so that no shuffle waits on the
            // chain and the 8 can issue back to back
#pragma unroll
            for (int u = 0; u < GROUP; ++u) {
                const XT o = __shfl_xor_sync(0xFFFFFFFFu, y[u], 1);
                const XT A = ch == 0 ? y[u] : o;        // channel 0
                const XT B = ch == 0 ? o : y[u];        // channel 1
                const UT mid = ((UT)A << 1) | ((UT)B & 1);
                if (ch == 0)
                    y[u] = a == ASG_RIGHT_SIDE ? (XT)((UT)B + (UT)A)
                           : a == ASG_MID_SIDE ? (XT)(mid + (UT)B) >> 1
                                               : A;
                else
                    y[u] = a == ASG_LEFT_SIDE ? (XT)((UT)A - (UT)B)
                           : a == ASG_MID_SIDE ? (XT)(mid - (UT)B) >> 1
                                               : B;
            }
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
            bad |= ((unsigned)(y[u] < -lim) | (unsigned)(y[u] >= lim)) &
                   check & (unsigned)(n0 + u < N);
        if (live) store_group<XT>(y, orow, out16, n0, N, vec_out);
#pragma unroll
        for (int u = 0; u < GROUP; ++u) cur[u] = nxt[u];
    }
    if (live && bad) oor[frame] = 1;
}

template <int MO, bool WIDE>
cudaError_t launch(const void* res, int rbytes, long long rstride,
                   bool vec_in, const void* order, const void* shift,
                   const void* qlp, const void* wasted, const void* asg,
                   void* pcm, bool out16, bool vec_out, void* oor, int S,
                   int N, int C, int bps, cudaStream_t st) {
    const int blocks = (S + THREADS - 1) / THREADS;
    restore_kernel<MO, WIDE><<<blocks, THREADS, 0, st>>>(
        (const char*)res, rbytes, rstride, vec_in, (const int*)order,
        (const int*)shift, (const int*)qlp, (const int*)wasted,
        (const int*)asg, (char*)pcm, out16, vec_out, (unsigned char*)oor, S,
        N, C, bps);
    return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_mo(int mo, const void* res, int rbytes, long long rstride,
                      bool vec_in, const void* order, const void* shift,
                      const void* qlp, const void* wasted, const void* asg,
                      void* pcm, bool out16, bool vec_out, void* oor, int S,
                      int N, int C, int bps, cudaStream_t st) {
#define FLAC_RESTORE_CASE(M)                                                  \
    case M:                                                                   \
        return launch<M, WIDE>(res, rbytes, rstride, vec_in, order, shift,    \
                               qlp, wasted, asg, pcm, out16, vec_out, oor, S, \
                               N, C, bps, st);
    switch (mo) {
        FLAC_RESTORE_CASE(1)
        FLAC_RESTORE_CASE(2)
        FLAC_RESTORE_CASE(4)
        FLAC_RESTORE_CASE(8)
        FLAC_RESTORE_CASE(12)
        FLAC_RESTORE_CASE(16)
        FLAC_RESTORE_CASE(32)
        default:
            return cudaErrorInvalidValue;
    }
#undef FLAC_RESTORE_CASE
}

}  // namespace

extern "C" {

// Restore S subframes of N samples each.  All pointers are device pointers:
// res rows of rstride elements of rbytes (2, 4 or 8) bytes, order/shift/
// wasted [S] int32, qlp [S, mo] int32 contiguous (mo one of 1, 2, 4, 8,
// 12, 16, 32), asg [S / C] int32 (read only when C == 2), pcm [S, N]
// contiguous (int16 when out16, else int32, int64 when wide), oor [S / C]
// bool, zeroed by the caller.  vec_in and vec_out allow 16-byte loads and
// stores (the caller has checked the alignment).  Returns the CUDA error
// code of the launch (0 on success).
int flac_restore(const void* res, int rbytes, long long rstride, int vec_in,
                 const void* order, const void* shift, const void* qlp,
                 int mo, const void* wasted, const void* asg, void* pcm,
                 int out16, int vec_out, void* oor, int S, int N, int C,
                 int wide, int bps, void* stream) {
    if (S <= 0 || N <= 0) return 0;
    if ((rbytes != 2 && rbytes != 4 && rbytes != 8) || rstride < N ||
        C <= 0 || S % C || bps < 0 || bps > 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e =
        wide ? launch_mo<true>(mo, res, rbytes, rstride, vec_in != 0, order,
                               shift, qlp, wasted, asg, pcm, out16 != 0,
                               vec_out != 0, oor, S, N, C, bps, st)
             : launch_mo<false>(mo, res, rbytes, rstride, vec_in != 0, order,
                                shift, qlp, wasted, asg, pcm, out16 != 0,
                                vec_out != 0, oor, S, N, C, bps, st);
    return (int)e;
}

}  // extern "C"
