// Rice/raw code scan of the device decoder (kernel K2 of flac_tpu_torch),
// plus the capability probe P2.
//
// Replaces flac_tpu/ops/bitunpack.py:_rice_kernel (the TPU's Pallas code
// scan, launched by _codes_pallas).  Same contract as its plain version,
// flac_tpu_torch/ops/bitunpack.py rice_codes_plain, which follows the
// reference's XLA-scan branch:
//
//   words   [R, 16] the stream as big-endian uint32 words (bits in int32),
//           in aligned 16-word rows
//   lane_start [L] int32, segs [L, SEG] int32 (SEG <= 8)
//   -> res [T, L] int32 (int64 for WIDE), ovf [L] bool
//
// Each lane (T samples of one subframe) owns the window of NROW rows from
// row lane_start >> 9; a word outside that window reads as 0, and rows past
// the end of `words` read the last row (the reference's gather clamps).
// Per step the lane pops its next packed segment
// (skip:16@15 | count:8@7 | param:6@1 | kind:1@0) when the current one is
// spent (a lane that spent all SEG slots reads segment 0: Rice, parameter
// 0, count 0), extracts 64 bits at its bit cursor, and decodes one code:
// a Rice code (unary run by clz in two 64-bit stages, stop bit, param-bit
// tail, zigzag unfold) or a raw param-bit signed value (width 0: zeros).
// A unary run of 128 zeros or more, or one that ends past the window's
// NROW * 512 bits, sets ovf.
//
// Design: one thread per lane, the segment queue in registers, every word
// read straight from the uploaded stream through L1/L2 (no window is
// materialised: the TPU needed one because it has no cheap per-lane
// gather), and res[t * L + lane] stored each step, which coalesces across
// a warp.  Shifts at or above the width are undefined in CUDA, so every
// variable shift is clamped as the plain version clamps it (a 32-bit shift
// by 32 or more gives 0, as XLA's does).
//
// Bound on an H100: per full -5 batch (1024 frames of 4096 stereo samples,
// L = 65,536 lanes, T = 128) the function reads the compressed stream once
// (~10.3 MB), segs (2.1 MB) and lane_start (0.26 MB) and writes res
// (33.5 MB) and ovf: ~46 MB, ~14 us at 3.35 TB/s.  Its ~8.4 M codes at a
// few tens of integer operations each are well under that at the card's
// non-tensor rate, so it is bound by bytes; a bit-serial walk per thread
// with scattered reads is far from either bound in practice.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int SEG_MAX = 8;

struct Window {
    const unsigned int* words;
    long long base;      // first word of the lane's window
    int nwords;          // NROW * 16
    long long last;      // index of the first word of the last row

    __device__ __forceinline__ unsigned int word(int i) const {
        if (i < 0 || i >= nwords) return 0u;
        long long w = base + i;
        // rows outside [0, R) clamp to the first or the last row
        if (w < 0) w &= 15;
        else if (w >= last + 16) w = last + (w & 15);
        return __ldg(words + w);
    }

    // bits [cur, cur + 64) MSB-first as (hi, lo)
    __device__ __forceinline__ void extract(int cur, unsigned int& hi,
                                            unsigned int& lo) const {
        const int w = cur >> 5;
        const unsigned int w0 = word(w), w1 = word(w + 1), w2 = word(w + 2);
        const int off = cur & 31;
        if (off) {
            hi = (w0 << off) | (w1 >> (32 - off));
            lo = (w1 << off) | (w2 >> (32 - off));
        } else {
            hi = w0;
            lo = w1;
        }
    }

    __device__ __forceinline__ unsigned int extract_hi(int cur) const {
        const int w = cur >> 5;
        const unsigned int w0 = word(w), w1 = word(w + 1);
        const int off = cur & 31;
        return off ? (w0 << off) | (w1 >> (32 - off)) : w0;
    }
};

__device__ __forceinline__ int clz64(unsigned int hi, unsigned int lo) {
    return hi ? __clz(hi) : 32 + __clz(lo);
}

__device__ __forceinline__ unsigned int shl32(unsigned int x, int s) {
    return s >= 32 ? 0u : x << s;
}

__device__ __forceinline__ unsigned int shr32(unsigned int x, int s) {
    return s >= 32 ? 0u : x >> s;
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
rice_codes_kernel(const unsigned int* __restrict__ words, long long R,
                  const int* __restrict__ lane_start,
                  const int* __restrict__ segs,
                  typename std::conditional<WIDE, long long, int>::type*
                      __restrict__ res,
                  unsigned char* __restrict__ ovf_out,
                  int L, int T, int NROW, int SEG, int seg_stride) {
    using val_t = typename std::conditional<WIDE, long long, int>::type;
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= L) return;

    const int ls = lane_start[lane];
    const int base_row = ls >> 9;
    Window win;
    win.words = words;
    win.base = (long long)base_row * 16;
    win.nwords = NROW * 16;
    win.last = (R - 1) * 16;
    const int max_bits = NROW * 512;

    int sq[SEG_MAX];
#pragma unroll
    for (int k = 0; k < SEG_MAX; ++k)
        sq[k] = k < SEG ? segs[(size_t)lane * seg_stride + k] : 0;

    int cur = ls - (base_row << 9);
    int rem = 0, param = 0, kind = 0;
    bool ovf = false;
    for (int t = 0; t < T; ++t) {
        if (rem == 0) {
            const int pk = sq[0];
#pragma unroll
            for (int k = 0; k < SEG_MAX - 1; ++k) sq[k] = sq[k + 1];
            sq[SEG_MAX - 1] = 0;
            cur += (pk >> 15) & 0xFFFF;
            rem = (pk >> 7) & 0xFF;
            param = (pk >> 1) & 0x3F;
            kind = pk & 1;
        }
        unsigned int hi, lo;
        win.extract(cur, hi, lo);
        const int sh32 = param > 0 ? 32 - min(param, 32) : 0;
        val_t val;
        if (kind == 1) {
            // raw: the top `param` bits, sign-extended (width 0 -> 0)
            if (WIDE) {
                unsigned long long rv = 0ull, sgn = 0ull;
                if (param > 0) {
                    const unsigned long long w64 =
                        ((unsigned long long)hi << 32) | lo;
                    rv = w64 >> (64 - param);          // param <= 63
                    sgn = (rv >> (param - 1)) & 1ull;
                }
                val = (val_t)(rv - (sgn << param));
            } else {
                unsigned int rv = 0u, sgn_term = 0u;
                if (param > 0) {
                    rv = hi >> sh32;
                    sgn_term = shl32(shr32(rv, param - 1) & 1u, param - 1);
                }
                val = (val_t)(int)(rv - sgn_term - sgn_term);
            }
            cur += param;
        } else {
            // Rice: unary run over up to 128 bits in two stages
            const int nz0 = clz64(hi, lo);
            int q = nz0;
            if (nz0 >= 64) {
                unsigned int hi2, lo2;
                win.extract(cur + 64, hi2, lo2);
                const int nz1 = clz64(hi2, lo2);
                q = 64 + nz1;
                if (nz1 >= 64) ovf = true;
            }
            const int cq = cur + q;
            if (cq > max_bits) ovf = true;
            const unsigned int lsb =
                param > 0 ? win.extract_hi(cq + 1) >> sh32 : 0u;
            if (WIDE) {
                const unsigned long long u =
                    ((unsigned long long)q << param) | lsb;
                val = (val_t)(u >> 1) ^ -(val_t)(u & 1ull);
            } else {
                const unsigned int u = shl32((unsigned int)q, param) | lsb;
                val = (val_t)(int)(u >> 1) ^ -(val_t)(int)(u & 1u);
            }
            cur = cq + 1 + param;
        }
        res[(size_t)t * L + lane] = val;
        --rem;
    }
    ovf_out[lane] = ovf ? 1 : 0;
}

__global__ void probe_clz_shift_kernel(const unsigned int* __restrict__ in,
                                       int* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        const unsigned int v = in[i];
        out[i] = (int)(__clz(v) + (v >> (v & 7u)));
    }
}

}  // namespace

extern "C" {

// Decode T codes for each of L lanes.  All pointers are device pointers of
// contiguous tensors: words [R, 16] int32, lane_start [L] int32, segs
// [L, seg_stride] int32, res [T, L] int32 (int64 when wide), ovf [L] bool.
// Returns the CUDA error code of the launch (0 on success).
int flac_rice_codes(const void* words, long long R, const void* lane_start,
                    const void* segs, void* res, void* ovf, int L, int T,
                    int NROW, int SEG, int seg_stride, int wide,
                    void* stream) {
    if (L <= 0) return 0;
    if (R <= 0 || T < 0 || NROW <= 0 || SEG <= 0 || SEG > SEG_MAX ||
        seg_stride < SEG)
        return (int)cudaErrorInvalidValue;
    const int blocks = (L + THREADS - 1) / THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (wide) {
        rice_codes_kernel<true><<<blocks, THREADS, 0, s>>>(
            (const unsigned int*)words, R, (const int*)lane_start,
            (const int*)segs, (long long*)res, (unsigned char*)ovf, L, T,
            NROW, SEG, seg_stride);
    } else {
        rice_codes_kernel<false><<<blocks, THREADS, 0, s>>>(
            (const unsigned int*)words, R, (const int*)lane_start,
            (const int*)segs, (int*)res, (unsigned char*)ovf, L, T, NROW,
            SEG, seg_stride);
    }
    return (int)cudaGetLastError();
}

// Capability probe: out[i] = clz(v) + (v >> (v & 7)) over n uint32 values.
int flac_probe_clz_shift(const void* in, void* out, int n, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    probe_clz_shift_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const unsigned int*)in, (int*)out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
