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
// 0, count 0) and decodes one code at its bit cursor: a Rice code (unary
// run, stop bit, param-bit tail, zigzag unfold) or a raw param-bit signed
// value (width 0: zeros).  A unary run of 128 zeros or more, or one that
// ends past the window's NROW * 512 bits, sets ovf.
//
// Design for Hopper (one thread per lane, THREADS lanes a CTA):
//   1. Staging.  The CTA reduces its lanes' first rows (lane_start >> 9) to
//      the span of rows their windows cover, [min, max + NROW).  If the
//      span fits STAGE_ROWS (48 KB), the CTA copies it once into shared
//      memory with coalesced 16-byte cp.async loads, rows outside [0, R)
//      clamped as the reference's gather clamps them.  On the decoder's
//      tables lanes run in stream order (lane = subframe * tiles + tile),
//      so 128 lanes cover about two stereo frames: ~20 KB at -5.  A CTA
//      whose span is larger (lanes far apart or out of order) reads its
//      words from global memory instead, in the same kernel; the host
//      mirror of this rule is ops/rice_cuda.py staged_ctas.
//   2. A bit reservoir in registers.  Each thread keeps the next 32 to 64
//      bits of its lane MSB-first in a 64-bit register and refills it one
//      32-bit word at a time; the window rule (outside it reads 0) runs at
//      the refill only.  A Rice code's unary run is the clz of the
//      reservoir; a run longer than the reservoir, a skip or a tail beyond
//      it seeks (reloads two words).  That is about one shared-memory read
//      per 32 bits consumed, against five global reads a code before.
//   3. The segment queue stays in registers, and res[t * L + lane] is
//      stored each step, which coalesces across a warp.
// Shifts at or above the width are undefined in CUDA, so every variable
// shift is clamped as the plain version clamps it (a 32-bit shift by 32 or
// more gives 0, as XLA's does).
//
// Bound on an H100: per full -5 batch (1024 frames of 4096 stereo samples,
// L = 65,536 lanes, T = 128) the function reads the compressed stream once
// (~10.3 MB), segs (2.1 MB) and lane_start (0.26 MB) and writes res
// (33.5 MB) and ovf: ~46 MB, ~14 us at 3.35 TB/s.  Its ~8.4 M codes at a
// few tens of integer operations each stay under that at the card's
// non-tensor rate, so bytes bound it.  What holds the kernel back is each
// lane's serial chain (a code's cursor depends on the previous code's
// clz) with only ~16 warps a SM to hide it: the reservoir shortens the
// chain, staging takes the scattered global reads out of it.
//
// The kernel adds each staged CTA to a device counter
// (flac_rice_staged_ctas), so a run can show which path its CTAs took.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;                // lanes a CTA
constexpr int NWARPS = THREADS / 32;
constexpr int SEG_MAX = 8;
constexpr int STAGE_BYTES = 48 * 1024;      // shared memory a CTA stages
constexpr int STAGE_ROWS = STAGE_BYTES / 64;

__device__ unsigned long long g_staged_ctas = 0;

__device__ __forceinline__ unsigned int shl32(unsigned int x, int s) {
    return s >= 32 ? 0u : x << s;
}

__device__ __forceinline__ unsigned int shr32(unsigned int x, int s) {
    return s >= 32 ? 0u : x >> s;
}

// A lane's window staged in shared memory: `s` is its first word.
struct StagedWindow {
    const unsigned int* s;
    int nwords;                 // NROW * 16

    __device__ __forceinline__ unsigned int word(int i) const {
        return (unsigned)i < (unsigned)nwords ? s[i] : 0u;
    }
};

// A lane's window read from global memory, rows clamped to [0, R).
struct GlobalWindow {
    const unsigned int* words;
    long long base;             // first word of the lane's window
    int nwords;                 // NROW * 16
    long long last;             // index of the first word of the last row

    __device__ __forceinline__ unsigned int word(int i) const {
        if ((unsigned)i >= (unsigned)nwords) return 0u;
        long long w = base + i;
        if (w < 0) w &= 15;
        else if (w >= last + 16) w = last + (w & 15);
        return __ldg(words + w);
    }
};

// The next bits of a lane, MSB-first in `buf`; bits past `nbits` are 0.
// `next` is the window index of the next word to load, so the cursor (the
// window bit of buf's top bit) is next * 32 - nbits.
template <class Win>
struct Reservoir {
    Win win;
    unsigned long long buf;
    int nbits;
    int next;

    __device__ __forceinline__ int pos() const { return next * 32 - nbits; }

    // Move the cursor to window bit p >= 0: two words, 33 to 64 bits.
    __device__ __forceinline__ void seek(int p) {
        next = p >> 5;
        buf = ((unsigned long long)win.word(next) << 32) | win.word(next + 1);
        next += 2;
        const int off = p & 31;
        buf <<= off;
        nbits = 64 - off;
    }

    // At least 32 valid bits afterwards.
    __device__ __forceinline__ void refill() {
        if (nbits <= 32) {
            buf |= (unsigned long long)win.word(next) << (32 - nbits);
            ++next;
            nbits += 32;
        }
    }

    // Advance the cursor by n >= 0 bits.
    __device__ __forceinline__ void skip(int n) {
        if (n < nbits) {
            buf <<= n;
            nbits -= n;
        } else {
            seek(pos() + n);
        }
    }

    // 64 bits at the cursor, beyond the reservoir's valid bits.
    __device__ __forceinline__ unsigned long long peek64() const {
        const int p = pos();
        const int w = p >> 5, off = p & 31;
        const unsigned int w0 = win.word(w), w1 = win.word(w + 1),
                           w2 = win.word(w + 2);
        const unsigned int hi = off ? (w0 << off) | (w1 >> (32 - off)) : w0;
        const unsigned int lo = off ? (w1 << off) | (w2 >> (32 - off)) : w1;
        return ((unsigned long long)hi << 32) | lo;
    }
};

// Decode T codes of one lane; returns its ovf flag.
template <bool WIDE, class Win>
__device__ __forceinline__ bool scan_lane(
        Win win, int start, const int (&seg_in)[SEG_MAX],
        typename std::conditional<WIDE, long long, int>::type* out,
        size_t L, int T, int max_bits) {
    using val_t = typename std::conditional<WIDE, long long, int>::type;
    int sq[SEG_MAX];
#pragma unroll
    for (int k = 0; k < SEG_MAX; ++k) sq[k] = seg_in[k];

    Reservoir<Win> r;
    r.win = win;
    r.seek(start);
    int rem = 0, param = 0, kind = 0;
    bool ovf = false;
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
        if (rem == 0) {
            const int pk = sq[0];
#pragma unroll
            for (int k = 0; k < SEG_MAX - 1; ++k) sq[k] = sq[k + 1];
            sq[SEG_MAX - 1] = 0;
            r.skip((pk >> 15) & 0xFFFF);
            rem = (pk >> 7) & 0xFF;
            param = (pk >> 1) & 0x3F;
            kind = pk & 1;
        }
        r.refill();
        val_t val;
        if (kind == 1) {
            // raw: the top `param` bits, sign-extended (width 0 -> 0)
            if (WIDE) {
                unsigned long long rv = 0ull, sgn = 0ull;
                if (param > 0) {
                    const unsigned long long w64 =
                        param <= r.nbits ? r.buf : r.peek64();
                    rv = w64 >> (64 - param);          // param <= 63
                    sgn = (rv >> (param - 1)) & 1ull;
                }
                val = (val_t)(rv - (sgn << param));
            } else {
                unsigned int rv = 0u, sgn_term = 0u;
                if (param > 0) {
                    rv = (unsigned int)(r.buf >> 32) >> (32 - min(param, 32));
                    sgn_term = shl32(shr32(rv, param - 1) & 1u, param - 1);
                }
                val = (val_t)(int)(rv - sgn_term - sgn_term);
            }
            r.skip(param);
        } else {
            // Rice: the unary run, capped at 128
            int q;
            const unsigned int hi = (unsigned int)(r.buf >> 32),
                               lo = (unsigned int)r.buf;
            const int len = __clz(hi) + 1 + param;
            if (len < 32) {
                // the whole code lies in the reservoir's top word (it holds
                // 32 valid bits after the refill): 32-bit operations only
                q = len - 1 - param;
                const unsigned int lsb =       // q + 1 <= 31 when param > 0
                    param > 0 ? (hi << (q + 1)) >> (32 - param) : 0u;
                r.buf = ((unsigned long long)__funnelshift_l(lo, hi, len)
                         << 32) | (lo << len);
                r.nbits -= len;
                if (WIDE) {
                    const unsigned long long u =
                        ((unsigned long long)q << param) | lsb;
                    val = (val_t)(u >> 1) ^ -(val_t)(u & 1ull);
                } else {
                    const unsigned int u = ((unsigned int)q << param) | lsb;
                    val = (val_t)(int)(u >> 1) ^ -(val_t)(int)(u & 1u);
                }
                *out = val;
                out += L;
                --rem;
                continue;
            }
            if (r.buf != 0ull) {
                // the stop bit is a valid bit, so it lies inside the
                // window: cur + q < NROW * 512 needs no test here
                q = __clzll((long long)r.buf);
                r.buf = (r.buf << q) << 1;
                r.nbits -= q + 1;
            } else {
                // the reservoir is all zeros and ends on a word boundary
                const int p0 = r.pos();
                int run = r.nbits, i = r.next;
                unsigned int w = 0u;
                while (run < 128 && (w = r.win.word(i)) == 0u) {
                    run += 32;
                    ++i;
                }
                if (run < 128) run += __clz(w);
                if (run >= 128) {
                    run = 128;
                    ovf = true;
                }
                q = run;
                if (p0 + q > max_bits) ovf = true;
                r.seek(p0 + q + 1);
            }
            r.refill();
            const unsigned int lsb = param > 0 ? (unsigned int)(r.buf >> 32)
                                                     >> (32 - min(param, 32))
                                               : 0u;
            if (WIDE) {
                const unsigned long long u =
                    ((unsigned long long)q << param) | lsb;
                val = (val_t)(u >> 1) ^ -(val_t)(u & 1ull);
            } else {
                const unsigned int u = shl32((unsigned int)q, param) | lsb;
                val = (val_t)(int)(u >> 1) ^ -(val_t)(int)(u & 1u);
            }
            r.skip(param);
        }
        *out = val;
        out += L;
        --rem;
    }
    return ovf;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
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
    extern __shared__ __align__(16) unsigned int stage[];
    __shared__ int warp_lo[NWARPS], warp_hi[NWARPS];

    const int lane = blockIdx.x * THREADS + threadIdx.x;
    const bool live = lane < L;
    const int ls = live ? lane_start[lane] : 0;
    const int base_row = ls >> 9;

    // the span of rows the CTA's windows cover, and the warp's own
    const int wlo = __reduce_min_sync(0xffffffffu, live ? base_row : INT_MAX);
    const int whi = __reduce_max_sync(0xffffffffu, live ? base_row : INT_MIN);
    if ((threadIdx.x & 31) == 0) {
        warp_lo[threadIdx.x >> 5] = wlo;
        warp_hi[threadIdx.x >> 5] = whi;
    }
    __syncthreads();
    int lo = wlo, hi = whi;
#pragma unroll
    for (int k = 0; k < NWARPS; ++k) {
        lo = min(lo, warp_lo[k]);
        hi = max(hi, warp_hi[k]);
    }
    const long long span = (long long)hi - lo + NROW;
    const bool staged = span <= STAGE_ROWS;
    if (staged) {
        // each warp copies the rows of its own lanes' windows to their
        // place in the CTA's span and waits for those only, so a warp
        // starts as soon as its rows land (rows two warps share are
        // written twice with the same words)
        if (wlo <= whi) {
            const int chunks = (whi - wlo + NROW) * 4;     // 16-byte pieces
            unsigned int* dst = stage + (wlo - lo) * 16;
            for (int c = threadIdx.x & 31; c < chunks; c += 32) {
                long long row = (long long)wlo + (c >> 2);
                row = row < 0 ? 0 : (row >= R ? R - 1 : row);
                cp_async16(dst + c * 4, words + row * 16 + (c & 3) * 4);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        if (threadIdx.x == 0) atomicAdd(&g_staged_ctas, 1ull);
    }
    if (!live) return;

    int sq[SEG_MAX];
#pragma unroll
    for (int k = 0; k < SEG_MAX; ++k)
        sq[k] = k < SEG ? segs[(size_t)lane * seg_stride + k] : 0;
    const int start = ls - (base_row << 9);
    const int nwords = NROW * 16;
    bool ovf;
    if (staged) {
        StagedWindow win{stage + (base_row - lo) * 16, nwords};
        ovf = scan_lane<WIDE>(win, start, sq, res + lane, (size_t)L, T,
                              NROW * 512);
    } else {
        GlobalWindow win{words, (long long)base_row * 16, nwords,
                         (R - 1) * 16};
        ovf = scan_lane<WIDE>(win, start, sq, res + lane, (size_t)L, T,
                              NROW * 512);
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

template <bool WIDE>
cudaError_t launch(const void* words, long long R, const void* lane_start,
                   const void* segs, void* res, void* ovf, int L, int T,
                   int NROW, int SEG, int seg_stride, cudaStream_t s) {
    using val_t = typename std::conditional<WIDE, long long, int>::type;
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            rice_codes_kernel<WIDE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
        if (e != cudaSuccess) return e;
        attr_set = true;
    }
    const int blocks = (L + THREADS - 1) / THREADS;
    rice_codes_kernel<WIDE><<<blocks, THREADS, STAGE_BYTES, s>>>(
        (const unsigned int*)words, R, (const int*)lane_start,
        (const int*)segs, (val_t*)res, (unsigned char*)ovf, L, T, NROW, SEG,
        seg_stride);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Decode T codes for each of L lanes.  All pointers are device pointers of
// contiguous tensors: words [R, 16] int32 (16-byte aligned), lane_start [L]
// int32, segs [L, seg_stride] int32, res [T, L] int32 (int64 when wide),
// ovf [L] bool.  Returns the CUDA error code of the launch (0 on success).
int flac_rice_codes(const void* words, long long R, const void* lane_start,
                    const void* segs, void* res, void* ovf, int L, int T,
                    int NROW, int SEG, int seg_stride, int wide,
                    void* stream) {
    if (L <= 0) return 0;
    if (R <= 0 || T < 0 || NROW <= 0 || SEG <= 0 || SEG > SEG_MAX ||
        seg_stride < SEG || ((uintptr_t)words & 15))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e =
        wide ? launch<true>(words, R, lane_start, segs, res, ovf, L, T, NROW,
                            SEG, seg_stride, s)
             : launch<false>(words, R, lane_start, segs, res, ovf, L, T,
                             NROW, SEG, seg_stride, s);
    return (int)e;
}

// CTAs that took the staged path since the library was loaded, on the
// current device, into *out.  Returns the CUDA error code of the read.
int flac_rice_staged_ctas(long long* out) {
    unsigned long long v = 0;
    const cudaError_t e =
        cudaMemcpyFromSymbol(&v, g_staged_ctas, sizeof(v));
    *out = (long long)v;
    return (int)e;
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
