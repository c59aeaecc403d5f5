// Bit-pack deposit of FLAC field lists into big-endian 32-bit word buffers
// (kernel K1 of flac_tpu_torch), plus the capability probe P1.
//
// Replaces flac_tpu/ops/pack_pallas.py:_kernel (the TPU's bf16 one-hot
// matmul deposit).  Same contract as flac_tpu_torch/ops/bitpack.py
// pack_fields64, its plain version: every field emits nzeros zero bits and
// then a pbits-bit payload (LSB-aligned, up to 63 bits); fields follow each
// other without gaps.
//
// Design: one CTA per frame.
//   1. The block walks the frame's S fields in chunks of THREADS.  A block
//      scan (warp shuffles, then a scan of the warp totals) of
//      nzeros + pbits gives each field's end bit, with a running carry
//      between chunks (int32 wrap-around semantics, as the reference's
//      cumsum).
//   2. Each field has three word-aligned contributions, word w0 + j for
//      j = 0..2, with the left-shift d = 32*(j+1) - t (t = field end within
//      its three-word window), exactly as bitpack._field_contribs64 clamps
//      them.  They are atomicOr'ed into a zeroed shared-memory tile of the
//      frame's words: fields cover disjoint bit ranges, so or == add.
//   3. The tile is stored to global memory with coalesced writes, and
//      thread 0 writes the frame's total bit count.
// Frames wider than the tile (TILE_WORDS_MAX) are deposited one tile at a
// time, rescanning the fields for each tile.
//
// Word indices >= W are dropped (negative ones wrap once first), as the
// reference scatter's mode="drop" does; fields with pbits == 0 contribute
// nothing.
//
// Output convention: words_out is an int64 tensor [B, W] holding each
// big-endian uint32 word zero-extended, the port's word type, so the
// wrapper returns it as it is.
//
// Bound on an H100: per -5 batch (B=64, S=2263, W=8192) the deposit reads
// 64*2263*16 B ~ 2.3 MB and writes 64*8192*4 B ~ 2.1 MB of uint32 words,
// ~1.3 us of HBM time at 3.35 TB/s, and does about 16 integer operations
// per field, so it is bound by bytes, and in practice by its launch and its
// 64 CTAs (one per frame) on 132 SMs.  Storing the words zero-extended in
// int64 (the output convention above) doubles the kernel's own writes; the
// bound counts the function's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE_WORDS_MAX = 16384;   // 64 KB of dynamic shared memory

__global__ void __launch_bounds__(THREADS)
pack_fields64_kernel(const int* __restrict__ nzeros,
                     const unsigned long long* __restrict__ payload,
                     const int* __restrict__ pbits,
                     long long* __restrict__ words,
                     int* __restrict__ total_bits,
                     int S, int W, int tile_words) {
    extern __shared__ unsigned int tile[];
    __shared__ unsigned int warp_sums[NWARPS];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t row = (size_t)b * (size_t)S;
    long long* out = words + (size_t)b * (size_t)W;

    for (int tile0 = 0; tile0 < W; tile0 += tile_words) {
        for (int i = tid; i < tile_words; i += THREADS) tile[i] = 0u;
        __syncthreads();

        unsigned int carry = 0u;   // bits of all fields before this chunk
        for (int c0 = 0; c0 < S; c0 += THREADS) {
            const int s = c0 + tid;
            int pb = 0;
            unsigned int nb = 0u;
            unsigned long long pay = 0ull;
            if (s < S) {
                pb = pbits[row + s];
                nb = (unsigned int)nzeros[row + s] + (unsigned int)pb;
                pay = payload[row + s];
            }
            // inclusive scan within the warp
            unsigned int v = nb;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                unsigned int n = __shfl_up_sync(0xffffffffu, v, o);
                if (lane >= o) v += n;
            }
            if (lane == 31) warp_sums[warp] = v;
            __syncthreads();
            // inclusive scan of the warp totals, by warp 0
            if (warp == 0) {
                unsigned int ws = lane < NWARPS ? warp_sums[lane] : 0u;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    unsigned int n = __shfl_up_sync(0xffffffffu, ws, o);
                    if (lane >= o) ws += n;
                }
                if (lane < NWARPS) warp_sums[lane] = ws;
            }
            __syncthreads();
            const unsigned int end =
                carry + v + (warp > 0 ? warp_sums[warp - 1] : 0u);
            const unsigned int chunk_total = warp_sums[NWARPS - 1];

            if (s < S && pb > 0) {
                const int pos = (int)(end - (unsigned int)pb);
                const int w0 = pos >> 5;              // arithmetic, as int32
                const int t = (pos & 31) + pb;
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    const int d = 32 * (j + 1) - t;
                    unsigned long long c;
                    if (d >= 0) {
                        c = d >= 64 ? 0ull : (pay << (d > 63 ? 63 : d));
                    } else {
                        c = pay >> (-d > 63 ? 63 : -d);
                    }
                    const unsigned int cw = (unsigned int)c;
                    int word = w0 + j;
                    if (word < 0) word += W;
                    if (cw != 0u && word >= tile0 && word < W &&
                        word < tile0 + tile_words) {
                        atomicOr(&tile[word - tile0], cw);
                    }
                }
            }
            carry += chunk_total;
            __syncthreads();   // warp_sums is rewritten by the next chunk
        }

        const int n = min(tile_words, W - tile0);
        for (int i = tid; i < n; i += THREADS)
            out[tile0 + i] = (long long)tile[i];   // zero-extends
        if (tile0 == 0 && tid == 0) total_bits[b] = (int)carry;
        __syncthreads();       // the tile is cleared by the next pass
    }
}

__global__ void probe_x2_kernel(const int* __restrict__ in,
                                int* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = in[i] * 2;
}

}  // namespace

extern "C" {

// Deposit B frames of S fields into words_out [B, W]; all pointers are
// device pointers of contiguous row-major tensors.  Returns the CUDA error
// code of the launch (0 on success).
int flac_pack_fields64(const void* nzeros, const void* payload,
                       const void* pbits, void* words_out,
                       void* total_bits_out, int B, int S, int W,
                       void* stream) {
    if (B <= 0) return 0;
    if (S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            pack_fields64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TILE_WORDS_MAX * (int)sizeof(unsigned int));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const int tile_words = W < TILE_WORDS_MAX ? W : TILE_WORDS_MAX;
    const size_t smem = (size_t)tile_words * sizeof(unsigned int);
    pack_fields64_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)nzeros, (const unsigned long long*)payload,
        (const int*)pbits, (long long*)words_out, (int*)total_bits_out,
        S, W, tile_words);
    return (int)cudaGetLastError();
}

// Capability probe: out[i] = 2 * in[i] over n int32 values.
int flac_probe_x2(const void* in, void* out, int n, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    probe_x2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
