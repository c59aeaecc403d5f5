// CRC-8 and CRC-16 of packed FLAC frames (kernel K5 of flac_tpu_torch).
//
// Replaces the CRC stage of flac_tpu/models/frame.py:assemble_frames
// (:397-404: bitpack.crc8_prefix, crc16_words and three deposit_byte calls),
// a bit-serial GF(2) fold on the TPU.  Same contract as
// flac_tpu_torch/models/frame.py seal_frames_plain, its plain version:
// CRC-8 (poly 0x07, init 0) over each frame's first hdr_bytes bytes,
// added into the zero byte at hdr_bytes; then CRC-16 (poly 0x8005, init 0,
// not reflected) over its first byte_len - 2 bytes, added into the two
// zero bytes after them.  Bytes are big-endian within each uint32 word,
// carried zero-extended in int64.  The kernel seals the words in place.
//
// Design: one CTA of THREADS threads a frame.  The byte tables and
// x^(8 * 2^i) mod p (POW_TERMS entries) go to shared memory.  Thread 0 runs
// the CRC-8 table over the header (at most 15 bytes) and deposits it; after
// a barrier each thread runs the CRC-16 table over a contiguous run of the
// frame's words, then multiplies its remainder by x^(8 * bytes after its
// run) mod p, one GF(2) product a set bit of that count; with init 0 the
// CRC is linear in the message, so the XOR of the threads' results is the
// frame's CRC.  It stops at byte_len - 2 exactly (bytes past the buffer
// count as zeros) and touches no word outside [0, W).
//
// Bound on an H100: per -5 batch (B=64 frames of ~9 KB) it must read each
// frame's bytes once (~0.6 MB) and write three bytes a frame: ~0.2 us of
// HBM time at 3.35 TB/s.  One table lookup a byte, a thread's run read in
// order; 64 CTAs on 132 SMs, so a launch is latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int POW_TERMS = 32;
constexpr unsigned int POLY16 = 0x8005u;
constexpr long long U32 = 0xFFFFFFFFLL;

// (a * b) mod p for the CRC-16 polynomial, a and b below 2^16
__device__ __forceinline__ unsigned int mulmod16(unsigned int a,
                                                 unsigned int b) {
    unsigned int prod = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if ((b >> j) & 1u) prod ^= a << j;
#pragma unroll
    for (int bit = 30; bit >= 16; --bit)
        if ((prod >> bit) & 1u) prod ^= (0x10000u | POLY16) << (bit - 16);
    return prod;
}

// words[idx / 4] += value << (its byte's shift), dropped outside [0, W)
__device__ __forceinline__ void deposit(long long* row, int W, long long idx,
                                        unsigned int value) {
    if (idx < 0 || (idx >> 2) >= W) return;
    const int sh = (3 - (int)(idx & 3)) * 8;
    long long* w = row + (idx >> 2);
    *w = (*w + (((long long)value << sh) & U32)) & U32;
}

__global__ void __launch_bounds__(THREADS) frame_crc_kernel(
        long long* words, const int* byte_len, const int* hdr_bytes,
        const int* tables, int W) {
    __shared__ unsigned int t8[256], t16[256], xp[POW_TERMS];
    __shared__ unsigned int s_crc;
    for (int i = threadIdx.x; i < 256; i += THREADS) {
        t8[i] = (unsigned int)tables[i];
        t16[i] = (unsigned int)tables[256 + i];
    }
    if (threadIdx.x < POW_TERMS) xp[threadIdx.x] = tables[512 + threadIdx.x];
    if (threadIdx.x == 0) s_crc = 0;
    const int b = blockIdx.x;
    long long* row = words + (size_t)b * W;
    const long long nbytes = 4LL * W;
    __syncthreads();

    if (threadIdx.x == 0) {
        const int hb = hdr_bytes[b];
        unsigned int crc = 0;
        for (int i = 0; i < hb; ++i) {
            const unsigned int byte = i < nbytes
                ? (unsigned int)(row[i >> 2] >> (24 - 8 * (i & 3))) & 0xFFu
                : 0u;
            crc = t8[crc ^ byte];
        }
        deposit(row, W, hb, crc);
    }
    __syncthreads();

    long long L = (long long)byte_len[b] - 2;          // bytes under CRC-16
    if (L < 0) L = 0;
    const long long have = L < nbytes ? L : nbytes;    // of them in the row
    const long long nw = (have + 3) >> 2;
    const long long per = (nw + THREADS - 1) / THREADS;
    const long long w0 = threadIdx.x * per;
    const long long w1 = w0 + per < nw ? w0 + per : nw;
    if (w0 < w1) {
        const long long end = 4 * w1 < have ? 4 * w1 : have;
        unsigned int r = 0;
        for (long long w = w0; w < w1; ++w) {
            const unsigned int word = (unsigned int)row[w];
            const int nb = end - 4 * w < 4 ? (int)(end - 4 * w) : 4;
            for (int k = 0; k < nb; ++k) {
                const unsigned int byte = (word >> (24 - 8 * k)) & 0xFFu;
                r = ((r << 8) & 0xFFFFu) ^ t16[(r >> 8) ^ byte];
            }
        }
        unsigned long long after = (unsigned long long)(L - end);
        for (int i = 0; after != 0 && i < POW_TERMS; ++i, after >>= 1)
            if (after & 1u) r = mulmod16(r, xp[i]);
        atomicXor(&s_crc, r);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int crc = s_crc;
        const long long at = (long long)byte_len[b] - 2;
        deposit(row, W, at, crc >> 8);
        deposit(row, W, at + 1, crc & 0xFFu);
    }
}

}  // namespace

extern "C" {

// Seal B frames of the [B, W] int64 word rows `words` in place; byte_len
// and hdr_bytes [B] int32, tables the [512 + POW_TERMS] int32 CRC tables
// (ops/seal_cuda.py:tables), all device pointers.  Returns the CUDA error
// code of the launch (0 on success).
int flac_frame_crc(void* words, const void* byte_len, const void* hdr_bytes,
                   const void* tables, int B, int W, void* stream) {
    if (B <= 0) return 0;
    if (W < 4) return (int)cudaErrorInvalidValue;
    frame_crc_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (long long*)words, (const int*)byte_len, (const int*)hdr_bytes,
        (const int*)tables, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
