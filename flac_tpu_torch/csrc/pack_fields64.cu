// Bit-pack deposit of FLAC field lists into big-endian 32-bit word buffers
// (kernel K1 of flac_tpu_torch), plus the capability probe P1.
//
// Replaces flac_tpu/ops/pack_pallas.py:_kernel (the TPU's bf16 one-hot
// matmul deposit).  Same contract as flac_tpu_torch/ops/bitpack.py
// pack_fields64, its plain version: every field emits nzeros zero bits and
// then a pbits-bit payload (LSB-aligned, up to 63 bits); fields follow each
// other without gaps.
//
// Design for Hopper: a thread block cluster of CLUSTER CTAs per frame.
//   1. Load once, scan once.  Rank r of the cluster takes the r-th of
//      CLUSTER contiguous shares of the frame's S fields; its threads load
//      FPT consecutive fields each into registers and one block scan
//      (warp shuffles, then a scan of the warp totals) of nzeros + pbits
//      gives each field's end bit within the share (int32 wrap-around, as
//      the reference's cumsum).
//   2. Offsets through distributed shared memory.  Each CTA publishes its
//      share's bit total; after cluster.sync() it reads the lower ranks'
//      totals (map_shared_rank) for its bit offset, and rank 0 writes the
//      frame's total bit count.
//   3. The frame's word tile is split among the cluster's shared memories,
//      rank r owning `tile_words` consecutive words.  Each field has three
//      word-aligned contributions, word w0 + j for j = 0..2, with the
//      left-shift d = 32*(j+1) - t (t = field end within its three-word
//      window), clamped exactly as bitpack._field_contribs64 clamps them;
//      each is atomicOr'ed into the tile of the CTA that owns its word,
//      local or remote (fields cover disjoint bit ranges, so or == add).
//   4. After cluster.sync() each CTA stores its words with 16-byte stores
//      (two zero-extended int64 words each).
// A frame wider than the cluster's tiles (CLUSTER * TILE_WORDS_MAX words)
// is deposited in passes of that many words; a share of more than CHUNK
// fields is scanned chunk by chunk (its total first, for the offsets).
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
// per field, so it is bound by bytes.  At this size a launch is a few
// dependent memory latencies: the design spreads each frame over CLUSTER
// SMs (128 CTAs on 132 SMs instead of 64), loads the fields in one batch
// and syncs the cluster twice.  Storing the words zero-extended in int64
// (the output convention above) doubles the kernel's own writes; the bound
// counts the function's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 2;               // CTAs a frame
constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int FPT = 2;                   // fields a thread holds
constexpr int CHUNK = THREADS * FPT;     // fields a CTA scans at once
constexpr int TILE_WORDS_MAX = 16384;    // 64 KB of dynamic shared memory

// Exclusive block scan of one value a thread; *total gets the block's sum.
__device__ __forceinline__ unsigned int block_scan(unsigned int v,
                                                   unsigned int* total,
                                                   unsigned int* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned int n = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += n;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned int ws = lane < NWARPS ? warp_sums[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned int n = __shfl_up_sync(0xffffffffu, ws, o);
            if (lane >= o) ws += n;
        }
        if (lane < NWARPS) warp_sums[lane] = ws;
    }
    __syncthreads();
    const unsigned int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0u);
    *total = warp_sums[NWARPS - 1];
    __syncthreads();                     // warp_sums is rewritten next call
    return excl;
}

// Every thread of the cluster arrives; shared-memory writes before it,
// local, remote or atomic, are seen by every thread of the cluster after
// it.  The barrier itself, with release and acquire at cluster scope:
// cooperative_groups' cluster.sync() adds a GPU-wide fence and an L1
// invalidation (MEMBAR.ALL.GPU, CCTL.IVALL) that the tiles do not need.
__device__ __forceinline__ void cluster_barrier() {
    if (CLUSTER == 1) {
        __syncthreads();
    } else {
        asm volatile("barrier.cluster.arrive.release.aligned;\n"
                     "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
}

// Fields f0 + c0 + tid*FPT + k (k < FPT) of the share [f0, f1) of row
// `row`; past f1 a field is empty.
struct Fields {
    int pb[FPT];
    unsigned int nb[FPT];                // nzeros + pbits
    unsigned long long pay[FPT];
    unsigned int sum;                    // of nb
    int neg;                             // some nzeros < 0

    __device__ __forceinline__ void load(const int* __restrict__ nzeros,
                                         const unsigned long long* __restrict__ payload,
                                         const int* __restrict__ pbits,
                                         size_t row, int first, int f1,
                                         bool with_payload) {
        sum = 0u;
        neg = 0;
#pragma unroll
        for (int k = 0; k < FPT; ++k) {
            const int s = first + k;
            pb[k] = 0;
            nb[k] = 0u;
            pay[k] = 0ull;
            if (s < f1) {
                const int nz = nzeros[row + s];
                pb[k] = pbits[row + s];
                nb[k] = (unsigned int)nz + (unsigned int)pb[k];
                neg |= nz < 0;
                if (with_payload) pay[k] = payload[row + s];
            }
            sum += nb[k];
        }
    }
};

// OR `cw` into word `word` (before the negative wrap) of the owner's tile;
// words outside [pass0, pass0 + CLUSTER * own) belong to another pass.
__device__ __forceinline__ void put(int word, unsigned int cw, int W,
                                    int pass0, int own, int rank,
                                    unsigned int* tile,
                                    cg::cluster_group& cluster) {
    if (word < 0) word += W;
    if (cw == 0u || word < pass0 || word >= W) return;
    const int rel = word - pass0;
    if (rel >= CLUSTER * own) return;
    int owner = 0;
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) owner += rel >= q * own;
    const int idx = rel - owner * own;
    if (owner == rank) {
        atomicOr(&tile[idx], cw);
    } else {
        atomicOr(cluster.map_shared_rank(&tile[idx], owner), cw);
    }
}

// The three contributions of each of a thread's fields, those to one word
// combined in a register first, so a word costs one atomic per thread.
__device__ __forceinline__ void deposit(const Fields& f, unsigned int start,
                                        int W, int pass0, int own, int rank,
                                        unsigned int* tile,
                                        cg::cluster_group& cluster) {
    unsigned int end = start;
    int word = 0;                        // the word `acc` gathers for
    unsigned int acc = 0u;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
        end += f.nb[k];
        const int pb = f.pb[k];
        if (pb <= 0) continue;
        const int pos = (int)(end - (unsigned int)pb);
        const int w0 = pos >> 5;                 // arithmetic, as int32
        const int t = (pos & 31) + pb;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int d = 32 * (j + 1) - t;
            unsigned long long c;
            if (d >= 0) {
                c = d >= 64 ? 0ull : (f.pay[k] << (d > 63 ? 63 : d));
            } else {
                c = f.pay[k] >> (-d > 63 ? 63 : -d);
            }
            const unsigned int cw = (unsigned int)c;
            if (cw == 0u) continue;
            if (w0 + j != word) {
                put(word, acc, W, pass0, own, rank, tile, cluster);
                word = w0 + j;
                acc = 0u;
            }
            acc |= cw;
        }
    }
    put(word, acc, W, pass0, own, rank, tile, cluster);
}

// out[w] = tile[w - base] for w in [lo, hi), or 0 without a tile; 16-byte
// stores (two zero-extended words) from the first 16-byte boundary of the
// output on.  `first` is the row's first element in the whole output.
__device__ __forceinline__ void store_words(long long* out, size_t first,
                                            const unsigned int* tile,
                                            int base, int lo, int hi) {
    if (lo >= hi) return;
    const int head = ((first + lo) & 1) ? 1 : 0;
    if (head && threadIdx.x == 0) out[lo] = tile ? tile[lo - base] : 0;
    const int pairs = (hi - lo - head) >> 1;
    longlong2* dst = reinterpret_cast<longlong2*>(out + lo + head);
    for (int i = threadIdx.x; i < pairs; i += THREADS) {
        const int w = lo + head + 2 * i - base;
        dst[i] = tile ? make_longlong2(tile[w], tile[w + 1])
                      : make_longlong2(0, 0);
    }
    if (((hi - lo - head) & 1) && threadIdx.x == 0)
        out[hi - 1] = tile ? tile[hi - 1 - base] : 0;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
pack_fields64_kernel(const int* __restrict__ nzeros,
                     const unsigned long long* __restrict__ payload,
                     const int* __restrict__ pbits,
                     long long* __restrict__ words,
                     int* __restrict__ total_bits,
                     int S, int W, int tile_words) {
    extern __shared__ __align__(16) unsigned int tile[];
    __shared__ unsigned int warp_sums[NWARPS];
    __shared__ unsigned int share_bits[CLUSTER];   // every rank's, pushed
    __shared__ int share_neg[CLUSTER];

    cg::cluster_group cluster = cg::this_cluster();
    // every CTA of the cluster must run before another stores into its
    // shared memory: arrive now, wait before the first remote store
    if (CLUSTER > 1)
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / CLUSTER;
    const int tid = threadIdx.x;
    const size_t row = (size_t)b * (size_t)S;
    const int per = (S + CLUSTER - 1) / CLUSTER;
    const int f0 = min(S, rank * per);
    const int f1 = min(S, f0 + per);
    const bool one_chunk = f1 - f0 <= CHUNK;

    // 1. the share's bit total (and, for one chunk, its scan)
    Fields f;
    unsigned int excl = 0u, total = 0u;
    int neg = 0;
    if (one_chunk) {
        f.load(nzeros, payload, pbits, row, f0 + tid * FPT, f1, true);
        neg = f.neg;
        excl = block_scan(f.sum, &total, warp_sums);
    } else {
        for (int c0 = f0; c0 < f1; c0 += CHUNK) {
            f.load(nzeros, payload, pbits, row, c0 + tid * FPT, f1, false);
            neg |= f.neg;
            unsigned int part;
            block_scan(f.sum, &part, warp_sums);
            total += part;
        }
    }
    neg = __syncthreads_or(neg);
    if (CLUSTER > 1)
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid < CLUSTER) {                 // push this share's total to all
        *cluster.map_shared_rank(&share_bits[rank], tid) = total;
        *cluster.map_shared_rank(&share_neg[rank], tid) = neg;
    }
    uint4* tile4 = reinterpret_cast<uint4*>(tile);
    for (int i = tid; i < tile_words / 4; i += THREADS)
        tile4[i] = make_uint4(0u, 0u, 0u, 0u);
    cluster_barrier();

    // 2. the bit offset of this share (the lower ranks' totals), and the
    // words that can hold bits: [0, used) when positions only grow (no
    // negative nzeros) and stay below 2^31, else all W
    unsigned int offset = 0u, frame_bits = 0u;
    int any_neg = 0;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
        if (q < rank) offset += share_bits[q];
        frame_bits += share_bits[q];
        any_neg |= share_neg[q];
    }
    const int used = any_neg || frame_bits >= 0x80000000u
                         ? W : (int)min((unsigned int)W,
                                        (frame_bits + 31u) >> 5);
    if (rank == 0 && tid == 0) total_bits[b] = (int)frame_bits;
    long long* out = words + (size_t)b * (size_t)W;
    const size_t first = (size_t)b * (size_t)W;

    // the words past `used` are zero: stored now, split over the ranks
    const int zper = (W - used + CLUSTER - 1) / CLUSTER;
    store_words(out, first, nullptr, 0, used + rank * zper,
                min(W, used + (rank + 1) * zper));

    // 3-4. deposit and store [0, used) in passes, rank r owning `own`
    // words of each
    const int own = min(tile_words, ((used + CLUSTER - 1) / CLUSTER + 3) & ~3);
    for (int pass0 = 0; pass0 < used; pass0 += CLUSTER * own) {
        if (pass0 > 0) {
            __syncthreads();             // this CTA's stores read the tile
            for (int i = tid; i < tile_words / 4; i += THREADS)
                tile4[i] = make_uint4(0u, 0u, 0u, 0u);
            cluster_barrier();           // every tile is clear
        }
        if (one_chunk) {
            deposit(f, offset + excl, W, pass0, own, rank, tile, cluster);
        } else {
            unsigned int carry = offset;
            for (int c0 = f0; c0 < f1; c0 += CHUNK) {
                Fields g;
                g.load(nzeros, payload, pbits, row, c0 + tid * FPT, f1,
                       true);
                unsigned int part;
                const unsigned int e = block_scan(g.sum, &part, warp_sums);
                deposit(g, carry + e, W, pass0, own, rank, tile, cluster);
                carry += part;
            }
        }
        cluster_barrier();               // every contribution has landed
        const int lo = pass0 + rank * own;
        store_words(out, first, tile, lo, lo, min(used, lo + own));
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
// device pointers of contiguous row-major tensors (words_out 16-byte
// aligned).  Returns the CUDA error code of the launch (0 on success).
int flac_pack_fields64(const void* nzeros, const void* payload,
                       const void* pbits, void* words_out,
                       void* total_bits_out, int B, int S, int W,
                       void* stream) {
    if (B <= 0) return 0;
    if (S <= 0 || W <= 0 || ((uintptr_t)words_out & 15))
        return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            pack_fields64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TILE_WORDS_MAX * (int)sizeof(unsigned int));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    // each rank's words, a multiple of 4 for the 16-byte clears
    int tile_words = ((W + CLUSTER - 1) / CLUSTER + 3) & ~3;
    if (tile_words > TILE_WORDS_MAX) tile_words = TILE_WORDS_MAX;
    const size_t smem = (size_t)tile_words * sizeof(unsigned int);
    pack_fields64_kernel<<<B * CLUSTER, THREADS, smem,
                           (cudaStream_t)stream>>>(
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
