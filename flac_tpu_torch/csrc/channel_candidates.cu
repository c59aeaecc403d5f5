// The encoder's channel candidates and wasted bits (kernel K10 of
// flac_tpu_torch).
//
// Replaces flac_tpu/models/stereo.py:29-90 (wasted_bits and
// build_channel_candidates) with the widening of the uploaded batch to
// int32 (flac_tpu/encoder.py:147), and on the loose mid-side path (-1,
// -4) loose_assignment's sums (:93-106), which XLA fuses into the jitted
// encode_batch on the TPU and the port ran as some fifteen small torch
// kernels a batch.  Same contract as flac_tpu_torch/models/stereo.py
// build_channel_candidates_plain and loose_assignment, its plain
// versions, bit for bit: from pcm [B, C, N] (int16 or int32), for the
// stereo mid-side search the candidates L, R, M = (L + R) >> 1 and
// S = L - R (int32, or int64 on the 33-bit side), else the channels as
// they are; each candidate's wasted bits w (the trailing zeros of the OR
// of its samples, 0 for an all-zero row; on the 33-bit side over the
// int32 wrap, and 32 for a row whose low 32 bits OR to zero but which is
// not all zero), x >> w and bps_eff = bps (bps + 1 for S) - w; and, asked
// for, the loose assignment: 0 (independent) where the sum of |dL| + |dR|
// is below the sum of |(dL + dR) >> 1| + |dL - dR|, else 3 (mid-side), the
// first differences in wrapping int32 and the sums in int64 (the plain
// version's float64 sums are exact integers below 2^53).
//
// Design (Hopper): a CTA of THREADS threads a frame on the mid-side path
// (a (frame, channel) otherwise), and SPLIT of them where fewer frames
// than SMs would leave SMs idle (-5's 64 frames; not the sharded form's
// 256); CTA p writes the p-th part of the samples (share, a multiple of
// 8) and no CTA waits on another.  Each reads the frame's rows in full,
// 4 samples of a row a load (8 bytes of int16, or 16 of int32), and ORs
// each candidate's samples (a warp __reduce_or_sync, then the warps'):
// the other parts' reads cost bytes from L2, not a wait on another CTA.
// It keeps its own part of the
// rows in shared memory as int32 (a part past STAGE_BYTES reads its rows
// again instead), takes the wasted bits with __ffs and writes its part of
// every candidate's shifted samples with 16-byte stores (4 int32 or 2
// int64 a store).  Part 0 writes the wasted bits and bps_eff, and on the
// loose path sums the frame's first differences in int64.  The bound is
// bytes: the batch read once (1.0 MB of int16 at -5) and the candidates
// written (4.2 MB): ~1.6 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 512;            // threads a CTA
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 2;                // CTAs a frame with few frames
// a part's staged rows at most, so that the dynamic and the static shared
// memory stay within the 48 KB a launch takes without an opt-in
constexpr int STAGE_BYTES = 40 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
    const void* pcm;                    // [B, C, N] int16 or int32
    void* x;                            // [B, CH, N] int32 or int64
    int* bps_eff;                       // [B, CH]
    int* wasted;                        // [B, CH]
    int* loose;                         // [B] or null
    int C, N, bps;
    int split;                          // CTAs a frame: SPLIT or 1
    int share;                          // samples a part (a multiple of 8)
    int staged;                         // a part's rows in shared memory
    int vec;                            // vector loads and 16-byte stores
                                        // (N % 4 == 0, pcm and x aligned)
};

// the four candidates of one sample pair, as the plain version forms them
template <bool X64>
struct Cand {
    using T = typename std::conditional<X64, long long, int>::type;
    T v[4];
    __device__ __forceinline__ Cand(int l, int r) {
        v[0] = l;
        v[1] = r;
        if constexpr (X64) {
            v[2] = ((long long)l + r) >> 1;
            v[3] = (long long)l - r;
        } else {                        // int32 arithmetic that wraps
            v[2] = (int)((unsigned)l + (unsigned)r) >> 1;
            v[3] = (int)((unsigned)l - (unsigned)r);
        }
    }
};

template <typename T> struct Vec;
template <> struct Vec<int> { using type = int4; };
template <> struct Vec<long long> { using type = longlong2; };

// samples n..n+3 of a row (8 bytes of int16, or 16 bytes of int32)
__device__ __forceinline__ void load4(int (&v)[4], const int16_t* p) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = (int)(int16_t)(q.x & 0xFFFF);
    v[1] = q.x >> 16;
    v[2] = (int)(int16_t)(q.y & 0xFFFF);
    v[3] = q.y >> 16;
}
__device__ __forceinline__ void load4(int (&v)[4], const int* p) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// MS: the stereo mid-side candidates (split CTAs a frame, CH = 4); else a
// channel passes through (split CTAs a (frame, channel), CH = C).  X64:
// the 33-bit side (int64 candidates, wasted bits over the int32 wrap).
template <typename In, bool MS, bool X64>
__global__ void __launch_bounds__(THREADS)
channel_candidates_kernel(const Args a) {
    using Out = typename Cand<X64>::T;
    constexpr int CAND = MS ? 4 : 1;    // candidates a CTA
    constexpr int ROWS = MS ? 2 : 1;    // input rows a CTA
    constexpr int V = 16 / sizeof(Out); // samples a 16-byte store
    extern __shared__ __align__(16) int s_rows[];    // [ROWS][share]
    __shared__ unsigned s_or[WARPS][CAND], s_nz[WARPS];
    __shared__ long long s_sum[WARPS][2];
    __shared__ int s_w[CAND];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int N = a.N, S = a.share;
    const int part = blockIdx.x % a.split, unit = blockIdx.x / a.split;
    const int frame = MS ? unit : unit / a.C;
    const int ch = MS ? 0 : unit % a.C;              // the first row's
    const int CH = MS ? 4 : a.C;
    const In* src = static_cast<const In*>(a.pcm)
        + ((size_t)frame * a.C + ch) * N;
    const int p0 = min(N, part * S), p1 = min(N, p0 + S);
    const bool staged = a.staged;
    // sample n of input row k; n in this CTA's part once staged
    auto row = [&](int k, int n) -> int {
        return staged ? s_rows[k * S + n - p0] : (int)src[(size_t)k * N + n];
    };

    // the frame's rows: each candidate's OR, and this part staged
    unsigned o[CAND], nz = 0;
#pragma unroll
    for (int k = 0; k < CAND; ++k) o[k] = 0;
    auto take = [&](int l, int r) {
        if (MS) {
            const Cand<X64> c(l, r);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                o[k] |= (unsigned)c.v[k];
                nz |= (unsigned)(c.v[k] != 0) << k;
            }
        } else {
            o[0] |= (unsigned)l;
        }
    };
    if (a.vec) {                        // N, p0 and p1 are multiples of 4
        for (int n = 4 * t; n < N; n += 4 * THREADS) {
            int v[ROWS][4];
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
                load4(v[k], src + (size_t)k * N + n);
#pragma unroll
            for (int e = 0; e < 4; ++e) take(v[0][e], v[ROWS - 1][e]);
            if (staged && n >= p0 && n < p1) {
#pragma unroll
                for (int k = 0; k < ROWS; ++k)
                    *reinterpret_cast<int4*>(s_rows + k * S + n - p0) =
                        make_int4(v[k][0], v[k][1], v[k][2], v[k][3]);
            }
        }
    } else {
        for (int n = t; n < N; n += THREADS) {
            const int l = src[n], r = MS ? (int)src[N + n] : l;
            take(l, r);
            if (staged && n >= p0 && n < p1) {
                s_rows[n - p0] = l;
                if (MS) s_rows[S + n - p0] = r;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < CAND; ++k) o[k] = __reduce_or_sync(FULL, o[k]);
    nz = __reduce_or_sync(FULL, nz);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < CAND; ++k) s_or[warp][k] = o[k];
        s_nz[warp] = nz;
    }
    __syncthreads();
    if (t < CAND) {
        unsigned acc = 0, any = 0;
        for (int j = 0; j < WARPS; ++j) { acc |= s_or[j][t]; any |= s_nz[j]; }
        // the trailing zeros of the OR; on the 33-bit side a row whose low
        // 32 bits are all zero but which is not all zero has 32
        const int w = acc ? __ffs(acc) - 1 : (X64 && (any >> t & 1)) ? 32 : 0;
        s_w[t] = w;
        if (part == 0) {
            const size_t at = (size_t)frame * CH + ch + t;
            a.wasted[at] = w;
            a.bps_eff[at] = a.bps + (MS && t == 3) - w;
        }
    }

    // the loose mid-side sums of the frame's first differences, from
    // n = 1, in part 0
    const bool with_loose = MS && a.loose != nullptr && part == 0;
    if (with_loose) {
        long long lr = 0, ms = 0;
        for (int n = t + 1; n < N; n += THREADS) {
            const long long dl = (int)((unsigned)src[n]
                                       - (unsigned)src[n - 1]);
            const long long dr = (int)((unsigned)src[N + n]
                                       - (unsigned)src[N + n - 1]);
            lr += llabs(dl) + llabs(dr);
            ms += llabs((dl + dr) >> 1) + llabs(dl - dr);
        }
#pragma unroll
        for (int h = 16; h > 0; h >>= 1) {
            lr += __shfl_down_sync(FULL, lr, h);
            ms += __shfl_down_sync(FULL, ms, h);
        }
        if (lane == 0) { s_sum[warp][0] = lr; s_sum[warp][1] = ms; }
    }
    __syncthreads();
    if (with_loose && t == 0) {
        long long lr = 0, ms = 0;
        for (int j = 0; j < WARPS; ++j) {
            lr += s_sum[j][0];
            ms += s_sum[j][1];
        }
        a.loose[frame] = lr < ms ? 0 : 3;
    }

    // this part of every candidate's shifted samples
    int w[CAND];
#pragma unroll
    for (int k = 0; k < CAND; ++k) w[k] = s_w[k];
    Out* dst = static_cast<Out*>(a.x) + ((size_t)frame * CH + ch) * N;
    if (a.vec) {                        // p0 and p1 are multiples of V
        using VecT = typename Vec<Out>::type;
        for (int i = p0 / V + t; i < p1 / V; i += THREADS) {
            VecT out[CAND];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const int n = i * V + j;
                if (MS) {
                    const Cand<X64> c(row(0, n), row(1, n));
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        reinterpret_cast<Out*>(&out[k])[j] = c.v[k] >> w[k];
                } else {
                    reinterpret_cast<Out*>(&out[0])[j] =
                        (Out)row(0, n) >> w[0];
                }
            }
#pragma unroll
            for (int k = 0; k < CAND; ++k)
                reinterpret_cast<VecT*>(dst + (size_t)k * N)[i] = out[k];
        }
    } else {
        for (int n = p0 + t; n < p1; n += THREADS) {
            if (MS) {
                const Cand<X64> c(row(0, n), row(1, n));
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    dst[(size_t)k * N + n] = c.v[k] >> w[k];
            } else {
                dst[n] = (Out)row(0, n) >> w[0];
            }
        }
    }
}

template <typename In>
int launch(const Args& a, int units, int ms, int x64, cudaStream_t s) {
    const size_t smem =
        a.staged ? (size_t)(ms ? 2 : 1) * a.share * sizeof(int) : 0;
    const int ctas = units * a.split;
    if (ms && x64)
        channel_candidates_kernel<In, true, true>
            <<<ctas, THREADS, smem, s>>>(a);
    else if (ms)
        channel_candidates_kernel<In, true, false>
            <<<ctas, THREADS, smem, s>>>(a);
    else
        channel_candidates_kernel<In, false, false>
            <<<ctas, THREADS, smem, s>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K10 on B frames of C channels and N samples: pcm (int16 when in16, else
// int32), then x (int64 when x64), bps_eff, wasted and loose (null unless
// the loose assignment is asked for), all device pointers; ms: the stereo
// mid-side candidates (C == 2); x64 only with ms.  Returns the CUDA error
// code of the launch (0 on success).
int flac_channel_candidates(const void* pcm, void* x, void* bps_eff,
                            void* wasted, void* loose, int B, int C, int N,
                            int bps, int in16, int ms, int x64,
                            void* stream) {
    if (B <= 0 || C <= 0) return 0;
    if (N < 1 || (ms && C != 2) || (x64 && !ms) || (loose && !ms))
        return (int)cudaErrorInvalidValue;
    // SPLIT CTAs a unit where one a unit would leave SMs idle
    const int units = ms ? B : B * C;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int split = units < sms ? SPLIT : 1;
    const int share = ((N + split - 1) / split + 7) & ~7;
    const int staged = (ms ? 2 : 1) * (long long)share * 4 <= STAGE_BYTES;
    const int vec = N % 4 == 0 && ((uintptr_t)pcm & (in16 ? 7 : 15)) == 0
        && ((uintptr_t)x & 15) == 0;
    const Args a{pcm, x, (int*)bps_eff, (int*)wasted, (int*)loose, C, N, bps,
                 split, share, staged, vec};
    const cudaStream_t s = (cudaStream_t)stream;
    return in16 ? launch<int16_t>(a, units, ms, x64, s)
                : launch<int>(a, units, ms, x64, s);
}

}  // extern "C"
