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
// It stops at byte_len - 2 exactly (L < 0 counts as 0; bytes past the row
// count as zeros), adds each deposit into its byte with a 32-bit wrap, and
// touches no word outside [0, W).
//
// Design (Hopper): a thread block cluster of up to CLUSTER CTAs of 256
// threads a frame (fewer while the launch would pass CTA_TARGET CTAs),
// launched by cudaLaunchKernelEx with the size as an attribute
// (ops/seal_cuda.py cluster_size mirrors the rule).  With init 0 the CRC
// is linear in the message and leading zero bytes leave it unchanged, so
// the message's whole 8-byte pairs (two int64 words, one 16-byte load) are
// read end-aligned in a virtual message of K * T pairs, T the cluster's
// threads: column g holds pairs g, g + T, ... (neighbouring threads on
// neighbouring pairs: coalesced), each issued before any arithmetic.  A
// pair's CRC is 8 independent lookups of the slicing tables T_i[b] =
// b x^(16 + 8i) mod p; a column folds its pairs by Horner with the
// constant x^(64 T), and the columns fold by a tree whose level l
// multiplies by x^(64 2^l): shuffles within a warp, shared memory across
// warps, and each rank's result pushed to rank 0's shared memory
// (mapa / st.shared::cluster) before one cluster barrier.  A constant
// multiply is two 256-entry lookups, TL[r & 0xFF] ^ TH[r >> 8]; the
// tables are built on the host (seal_cuda.tables) and copied into shared
// memory at the start.  The warp that reads the CRC-8 byte's pair (rank
// 0's warp 0 where the pair lies past the whole pairs) computes the CRC-8
// from the header as each byte's bits times x^e mod p8 (a 127-entry table:
// x has order 127 mod p8) and one __reduce_xor_sync, and folds the
// deposited word in its place.  Rank 0's thread 0 adds the last partial
// pair (up to 7 bytes, one round of lookups) and the zeros past the row,
// once a frame, then writes the three deposits, whose words it read at the
// start: nothing is written before every rank has read what it needs.
//
// Bound on an H100: per -5 batch (B=64 frames of ~9 KB) it must read each
// frame's bytes once (~0.6 MB) and write three bytes a frame: ~0.2 us of
// HBM time at 3.35 TB/s, below any launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOG_THREADS = 8;         // CTAs of 256 threads
constexpr int THREADS = 1 << LOG_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;             // the most CTAs a frame
constexpr int CTA_TARGET = 132;        // CTAs a launch: one an SM
constexpr int POW_TERMS = 32;
constexpr int LEVELS = 12;             // x^(64 * 2^l), l = 0..11
constexpr int P8_LEN = 127;            // the order of x mod the CRC-8 poly
constexpr int U = 4;                   // pairs a column loads at a time
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr long long U32 = 0xFFFFFFFFLL;

// The shared-memory image of the host tables past the first 512 +
// POW_TERMS entries (seal_cuda.tables), then the reductions' slots.
struct Smem {
    unsigned short slice[8][256];      // T_i[b] = b x^(16 + 8i) mod p
    unsigned char p8[128];             // x^e mod the CRC-8 poly, e < 127
    unsigned short lvl[LEVELS][2][256];  // r x^(64 2^l): low byte, high
    unsigned warp_crc[WARPS];
    unsigned rank_crc[CLUSTER];        // in rank 0: each rank's remainder
    unsigned crc8;                     // in rank 0: the frame's CRC-8
};
constexpr int IMAGE_INT4 = (8 * 256 * 2 + 128) / 16;   // before lvl
constexpr int LEVEL_INT4 = 2 * 256 * 2 / 16;
// int4s a thread copies at most
constexpr int COPY = (IMAGE_INT4 + LEVELS * LEVEL_INT4 + THREADS - 1)
                     / THREADS;
// the Horner's level, LOG_THREADS + log2(cluster), has a table
static_assert(LOG_THREADS + (CLUSTER > 1) + (CLUSTER > 2) + (CLUSTER > 4)
              < LEVELS && WARPS <= 32, "K5: a level past the tables");

#include "cluster.cuh"

// r x^(64 2^l) mod p
__device__ __forceinline__ unsigned mul_level(const Smem& sh, int l,
                                              unsigned r) {
    return sh.lvl[l][0][r & 0xFFu] ^ sh.lvl[l][1][r >> 8];
}

// the CRC-16 of the 8 bytes of a pair (hi's four, then lo's)
__device__ __forceinline__ unsigned pair_crc(const Smem& sh, unsigned hi,
                                             unsigned lo) {
    return (sh.slice[7][hi >> 24] ^ sh.slice[6][(hi >> 16) & 0xFFu])
         ^ (sh.slice[5][(hi >> 8) & 0xFFu] ^ sh.slice[4][hi & 0xFFu])
         ^ (sh.slice[3][lo >> 24] ^ sh.slice[2][(lo >> 16) & 0xFFu])
         ^ (sh.slice[1][(lo >> 8) & 0xFFu] ^ sh.slice[0][lo & 0xFFu]);
}

// the remainder r continued over the first n (< 8) bytes of a pair: one
// round of lookups, r x^(8n) + sum b_j x^(16 + 8(n - 1 - j))
__device__ __forceinline__ unsigned crc_tail(const Smem& sh, unsigned r,
                                             unsigned hi, unsigned lo,
                                             int n) {
    if (n <= 0) return r;
    unsigned b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
        b[k] = ((k < 4 ? hi : lo) >> (24 - 8 * (k & 3))) & 0xFFu;
    b[0] ^= r >> 8;
    unsigned out = 0;
    if (n >= 2) b[1] ^= r & 0xFFu;
    else out = (r & 0xFFu) << 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        if (j < n) out ^= sh.slice[n - 1 - j][b[j]];
    return out;
}

// (a * b) mod p for the CRC-16 polynomial, a and b below 2^16
__device__ __forceinline__ unsigned mulmod16(unsigned a, unsigned b) {
    unsigned prod = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if ((b >> j) & 1u) prod ^= a << j;
#pragma unroll
    for (int bit = 30; bit >= 16; --bit)
        if ((prod >> bit) & 1u) prod ^= (0x10000u | 0x8005u) << (bit - 16);
    return prod;
}

// words[idx / 4] += value << (its byte's shift) in the uint32 word
__device__ __forceinline__ long long deposit(long long w, long long idx,
                                             unsigned value) {
    const int sh = (3 - (int)(idx & 3)) * 8;
    return (w + (((long long)value << sh) & U32)) & U32;
}

// pair p of a row: its two words as uint32
__device__ __forceinline__ void load_pair(const long long* row, long long p,
                                          int vec, unsigned& hi,
                                          unsigned& lo) {
    if (vec) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(row) + p);
        hi = (unsigned)v.x;
        lo = (unsigned)v.y;
    } else {
        hi = (unsigned)__ldg(row + 2 * p);
        lo = (unsigned)__ldg(row + 2 * p + 1);
    }
}

__global__ void __launch_bounds__(THREADS) frame_crc_kernel(
        long long* words, const int* byte_len, const int* hdr_bytes,
        const int* tables, int W, int vec) {
    __shared__ __align__(16) Smem sh;
    cluster_arrive_relaxed();
    const int rank = cluster_rank(), nc = cluster_size();
    const int b = blockIdx.x / nc;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    long long* row = words + (size_t)b * W;
    // T = 2^lx columns a cluster; its Horner multiplies by x^(64 T)
    const int lx = LOG_THREADS + (31 - __clz(nc));
    const long long T = 1LL << lx;
    const long long g = (long long)rank * THREADS + tid;       // the column

    // 1. every load first: the tables' image (whose loads need no length),
    // then this column's first U pairs, the header words of the CRC-8 warp,
    // the last thread's partial pair and deposit words
    const int4* src = reinterpret_cast<const int4*>(tables + 512 + POW_TERMS);
    const int n4 = IMAGE_INT4 + (lx + 1) * LEVEL_INT4;
    int4 img[COPY];
#pragma unroll
    for (int c = 0; c < COPY; ++c)
        if (tid + c * THREADS < n4) img[c] = __ldg(src + tid + c * THREADS);
    const int bl = byte_len[b], hb = hdr_bytes[b];
    const long long L = bl > 2 ? (long long)bl - 2 : 0;  // bytes under CRC-16
    const long long inrow = L < 4LL * W ? L : 4LL * W;   // of them in the row
    const long long Q = inrow >> 3;                      // whole pairs
    const long long K = (Q + T - 1) >> lx;               // pairs a column
    const long long off = K * T - Q;                     // leading zero pairs
    // the CRC-8 byte's pair: in the columns' pairs (pc < Q) or not
    const long long pc = hb >= 0 ? (long long)(hb >> 3) : -1;
    const bool in_cols = pc >= 0 && pc < Q;
    const long long v8 = in_cols ? off + pc : 0;
    const long long c8 = v8 & (T - 1), k8 = v8 >> lx;
    const bool crc8_warp = rank == (int)(c8 / THREADS)
                           && warp == (int)((c8 % THREADS) >> 5);
    const bool crc8_lane = crc8_warp && lane == (int)(c8 & 31) && in_cols;
    const bool last = rank == 0 && tid == 0;

    unsigned hi[U], lo[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long p = u * T + g - off;
        hi[u] = lo[u] = 0;
        if (u < K && p >= 0) load_pair(row, p, vec, hi[u], lo[u]);
    }
    unsigned hword = 0;
    if (crc8_warp && (lane >> 2) < W)
        hword = (unsigned)__ldg(row + (lane >> 2));
    unsigned t_hi = 0, t_lo = 0;
    long long dw[3] = {0, 0, 0};
    const long long didx[3] = {hb, (long long)bl - 2, (long long)bl - 1};
    if (last) {
        if (2 * Q < W) t_hi = (unsigned)row[2 * Q];
        if (2 * Q + 1 < W) t_lo = (unsigned)row[2 * Q + 1];
#pragma unroll
        for (int d = 0; d < 3; ++d)
            if (didx[d] >= 0 && (didx[d] >> 2) < W) dw[d] = row[didx[d] >> 2];
    }
#pragma unroll
    for (int c = 0; c < COPY; ++c)
        if (tid + c * THREADS < n4)
            reinterpret_cast<int4*>(&sh)[tid + c * THREADS] = img[c];
    __syncthreads();

    // 2. the CRC-8 (its warp only): byte i's bit k is x^(8(hb-1-i)+8+k)
    unsigned crc8 = 0;
    if (crc8_warp) {
        unsigned acc = 0;
        for (int i0 = 0; i0 < hb; i0 += 32) {
            const int i = i0 + lane;
            unsigned w = hword;
            if (i0 > 0) w = (i >> 2) < W ? (unsigned)__ldg(row + (i >> 2)) : 0;
            if (i < hb && (long long)i < 4LL * W) {
                const unsigned byte = (w >> (24 - 8 * (i & 3))) & 0xFFu;
                const int e = (8 * (hb - 1 - i) + 8) % P8_LEN;
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    if ((byte >> k) & 1u) acc ^= sh.p8[(e + k) % P8_LEN];
            }
        }
        crc8 = __reduce_xor_sync(FULL, acc);
    }

    // 3. each column's pairs by Horner, x^(64 T) a step
    unsigned H = 0;
    for (long long k0 = 0; k0 < K; k0 += U) {
        unsigned nhi[U], nlo[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long p = (k0 + U + u) * T + g - off;
            nhi[u] = nlo[u] = 0;
            if (k0 + U + u < K && p >= 0)
                load_pair(row, p, vec, nhi[u], nlo[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (crc8_lane && k0 + u == k8) {
                // the word under the CRC-8 deposit, as the plain version's
                // CRC-16 reads it
                if ((hb >> 2) & 1)
                    lo[u] = (unsigned)deposit(lo[u], hb, crc8);
                else
                    hi[u] = (unsigned)deposit(hi[u], hb, crc8);
            }
            if (k0 + u < K) H = mul_level(sh, lx, H) ^ pair_crc(sh, hi[u],
                                                                lo[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            hi[u] = nhi[u];
            lo[u] = nlo[u];
        }
    }

    // 4. the columns: a warp's by shuffles, the CTA's warps in warp 0
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        const unsigned o = __shfl_down_sync(FULL, H, 1 << l);
        H = mul_level(sh, l, H) ^ o;
    }
    if (lane == 0) sh.warp_crc[warp] = H;
    __syncthreads();
    unsigned cta = 0;
    if (warp == 0) {
        cta = lane < WARPS ? sh.warp_crc[lane] : 0;
#pragma unroll
        for (int l = 5; l < LOG_THREADS; ++l) {
            const unsigned o = __shfl_down_sync(FULL, cta, 1 << (l - 5));
            cta = mul_level(sh, l, cta) ^ o;
        }
    }
    // 5. each rank's remainder and the CRC-8 into rank 0, one barrier
    cluster_wait();
    if (tid == 0) store_remote(&sh.rank_crc[rank], 0, cta);
    if (crc8_warp && lane == 0) store_remote(&sh.crc8, 0, crc8);
    cluster_barrier();
    if (!last) return;

    // 6. rank 0's thread 0: the ranks, the partial pair, the zeros past the
    // row, then the deposits
    unsigned r = 0;
    for (int q = 0; q < nc; ++q)
        r = mul_level(sh, LOG_THREADS, r) ^ sh.rank_crc[q];
    const unsigned c8v = sh.crc8;
    if (hb >= 0 && pc == Q && (hb >> 2) < W) {
        if ((hb >> 2) & 1) t_lo = (unsigned)deposit(t_lo, hb, c8v);
        else t_hi = (unsigned)deposit(t_hi, hb, c8v);
    }
    r = crc_tail(sh, r, t_hi, t_lo, (int)(inrow - 8 * Q));
    unsigned long long after = (unsigned long long)(L - inrow);
    for (int i = 0; after != 0 && i < POW_TERMS; ++i, after >>= 1)
        if (after & 1u) r = mulmod16(r, (unsigned)tables[512 + i]);
    const unsigned val[3] = {c8v, r >> 8, r & 0xFFu};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        if (didx[d] < 0 || (didx[d] >> 2) >= W) continue;
        const long long w = deposit(dw[d], didx[d], val[d]);
#pragma unroll
        for (int e = d; e < 3; ++e)
            if (didx[e] >= 0 && (didx[e] >> 2) == (didx[d] >> 2)) dw[e] = w;
        row[didx[d] >> 2] = w;
    }
}

}  // namespace

extern "C" {

// Seal B frames of the [B, W] int64 word rows `words` in place; byte_len
// and hdr_bytes [B] int32, tables the int32 CRC tables of
// ops/seal_cuda.py:tables (the CRC-8 and CRC-16 byte tables and the
// POW_TERMS powers of x, then the shared-memory image), all device
// pointers.  Returns the CUDA error code of the launch (0 on success).
int flac_frame_crc(void* words, const void* byte_len, const void* hdr_bytes,
                   const void* tables, int B, int W, void* stream) {
    if (B <= 0) return 0;
    if (W < 4) return (int)cudaErrorInvalidValue;
    // a cluster of up to CLUSTER CTAs a frame, fewer where the batch would
    // launch more than CTA_TARGET CTAs
    int nc = CLUSTER;
    while (nc > 1 && (long long)B * nc > CTA_TARGET) nc >>= 1;
    const int vec = (int)((((uintptr_t)words & 15) == 0) && (W % 2 == 0));
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * nc, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, frame_crc_kernel, (long long*)words, (const int*)byte_len,
        (const int*)hdr_bytes, (const int*)tables, W, vec);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
