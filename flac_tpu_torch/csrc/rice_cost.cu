// The encoder's Rice cost table (kernel K7 of flac_tpu_torch).
//
// Replaces flac_tpu/ops/rice.py partition_cost_table (:66) with zigzag
// (:40) and flac_tpu/models/subframe.py _rice_cost (:60) and
// _max_po_limit (:53), which XLA fuses into the jitted encode_batch on the
// TPU; the port ran them op by op: the residuals zigzagged into an int64
// tensor ([64, 4, 6, 4096] at -5: 50 MB), then kmax + 1 shift-and-sum
// passes over it.  Same contract as flac_tpu_torch/models/subframe.py
// _rice_cost_plain, its plain version, bit for bit: for each row (frame,
// channel candidate, candidate) of N int32 residuals and its predictor
// order, at every partition order po of 0..max_po, the best Rice
// parameter of each of the 2^po partitions (first k on ties; an escaped
// partition as 64 + its raw width under escape coding), the bits of the
// whole level (clamped at BIG, BIG where partition 0 keeps no sample after
// the warm-up), both the 4-bit (kmax 14) and, where the configuration
// allows RICE2, the 5-bit (kmax 30) table with the cheaper one chosen, and
// the +6 bits of the method and order fields inside the levels that the
// order and min_residual_partition_order allow (BIG outside).
//
// Every value is an integer: the plain version's float64 costs are exact
// integers below 2^53, and here they are int64 sums, so the two agree by
// construction.  A partition's sums of u >> k need only its own samples,
// and a node's sums are its children's added, so the levels are one
// binary tree over the finest partitions.
//
// Design: one CTA of 8 warps a row.  A warp takes a subtree whose root is
// at level t = min(3, max_po) and walks its finest partitions in order.
// Its lanes are (k, g): lane k of group g sums u >> k over the samples
// i = g (mod G) of the partition, G = 2 for the 4-bit table alone (k in
// 0..15) and 1 where RICE2 needs k up to 30.  The warp loads 32 residuals
// a step (one a lane, coalesced), zigzags them in registers, ORs them
// (__reduce_or_sync: the escape's raw width) and broadcasts each to the
// lanes with __shfl_sync.  A finished node (a partition, or two children
// added) is costed at once: its groups' sums added (one shuffle), each
// lane's cost n_eff * (k + 1) + sum_k + plen, a warp argmin over (cost, k),
// the BIG clamp and the escape; lane 0 writes the parameter and adds the
// cost to its level's total in shared memory.  Children wait for their
// sibling on a stack in shared memory, one entry a level, so every
// partition order a configuration allows (up to 2^15 partitions of one
// sample) runs in the same shared memory.  The subtrees' roots meet in
// shared memory, where warp 0 costs the top levels; then the levels'
// totals give the bits, the RICE2 choice (the 5-bit table's parameters
// are written to a scratch row first and copied over where it wins) and
// the limits.  Parameters past a level's 2^po partitions are 0.
//
// Bound on an H100: at -5 a batch is 64 x 4 x 6 rows of 4096 int32
// residuals, 25.2 MB read once, and ~1.2 MB of parameters and bits written:
// ~7.9 us of HBM time at 3.35 TB/s.  Each sample costs a lane group a
// shuffle, a shift and a 64-bit add, so a launch is bound by that issue
// and the shuffles' latency rather than by the bytes (twice the work with
// RICE2, G = 1); chip_smoke.py measures it.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TOP = 3;                  // subtree roots: level min(3, max_po)
constexpr int LEVELS = 16;              // partition orders 0..15
constexpr int STACK = LEVELS - TOP - 1; // levels below a subtree root
constexpr long long BIG = 1LL << 28;    // ops/rice.py BIG
constexpr int ESCAPE_K_BASE = 64;       // ops/rice.py ESCAPE_K_BASE
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Tables {
    int* bits;              // [rows, L]
    int* ks;                // [rows, L, P]
    int* ks5;               // [rows, L, P] scratch (RICE2 only)
    unsigned char* rice2;   // [rows, L]
};

struct Shared {
    // a left child's sums, by level - TOP - 1, until its sibling is done
    unsigned long long stack[WARPS][STACK][32];
    unsigned stack_or[WARPS][STACK][32];
    unsigned long long top[1 << TOP][32];
    unsigned top_or[1 << TOP][32];
    unsigned long long total[2][LEVELS];
};

// cost a finished node: (level, idx) with its lanes' partial sums S and
// the OR of its u; lane 0 writes the parameters and adds to the totals
template <bool RICE2>
__device__ __forceinline__ void cost_node(Shared& sh, const Tables& t,
                                          long long row, int L, int P,
                                          int N, int order, int escape,
                                          int lvl, int idx,
                                          unsigned long long S,
                                          unsigned orv) {
    constexpr int KP = RICE2 ? 32 : 16;
    const int lane = threadIdx.x & 31;
    const int k = lane & (KP - 1);
    if (!RICE2) S += __shfl_xor_sync(FULL, S, 16);   // both sample groups
    const long long n_eff = (long long)(N >> lvl) - (idx == 0 ? order : 0);
    const int rawb = 32 - __clz((int)orv);
    const long long at = ((long long)row * L + lvl) * P + idx;
#pragma unroll
    for (int tb = 0; tb < (RICE2 ? 2 : 1); ++tb) {
        const int kmax = tb ? 30 : 14;
        const int plen = tb ? 5 : 4;
        long long cost = k <= kmax
            ? n_eff * (k + 1) + (long long)S + plen : LLONG_MAX;
        int bk = k;
#pragma unroll
        for (int off = KP / 2; off >= 1; off >>= 1) {
            const long long oc = __shfl_xor_sync(FULL, cost, off);
            const int ok = __shfl_xor_sync(FULL, bk, off);
            if (oc < cost || (oc == cost && ok < bk)) {
                cost = oc;
                bk = ok;
            }
        }
        long long best = cost < BIG ? cost : BIG;
        if (escape) {
            const long long esc = n_eff * rawb + plen + 5;
            if (esc < best) {
                best = esc;
                bk = ESCAPE_K_BASE + rawb;
            }
        }
        if (lane == 0) {
            (tb ? t.ks5 : t.ks)[at] = bk;
            atomicAdd(&sh.total[tb][lvl], (unsigned long long)best);
        }
    }
}

template <bool RICE2>
__global__ void __launch_bounds__(THREADS) rice_cost_kernel(
        const int* __restrict__ res, const int* __restrict__ order_in,
        Tables t, int N, int max_po, int min_po, int escape) {
    constexpr int KP = RICE2 ? 32 : 16;
    constexpr int G = 32 / KP;
    __shared__ Shared sh;
    const long long row = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int L = max_po + 1, P = 1 << max_po;
    const int order = order_in[row];
    const int k = lane & (KP - 1), g = lane / KP;
    if (threadIdx.x < 2 * LEVELS) (&sh.total[0][0])[threadIdx.x] = 0;
    // parameters past each level's partitions are 0, in both tables
    for (int e = threadIdx.x; e < L * P; e += THREADS) {
        const int lvl = e / P, idx = e - lvl * P;
        if (idx >= (1 << lvl)) {
            t.ks[row * L * P + e] = 0;
            if (RICE2) t.ks5[row * L * P + e] = 0;
        }
    }
    __syncthreads();

    const int top = max_po < TOP ? max_po : TOP;
    const int depth = max_po - top;          // levels below a subtree root
    const int m = N >> max_po;               // samples a finest partition
    const int* rrow = res + row * (long long)N;
    if (warp < (1 << top)) {
        const int first = warp << depth;
        for (int p = first; p < first + (1 << depth); ++p) {
            unsigned long long S = 0;
            unsigned orv = 0;
            for (int base = p * m; base < (p + 1) * m; base += 32) {
                const int n = min(32, (p + 1) * m - base);
                unsigned u = 0;
                if (lane < n) {
                    const int r = rrow[base + lane];
                    u = ((unsigned)r << 1) ^ (unsigned)(r >> 31);
                }
                orv |= __reduce_or_sync(FULL, u);
                if (n == 32) {
#pragma unroll
                    for (int i = 0; i < 32; i += G)
                        S += __shfl_sync(FULL, u, i + g) >> k;
                } else {
                    for (int i = 0; i < n; i += G)
                        S += __shfl_sync(FULL, u, i + g) >> k;
                }
            }
            int lvl = max_po, idx = p;
            cost_node<RICE2>(sh, t, row, L, P, N, order, escape, lvl, idx,
                             S, orv);
            while (lvl > top && (idx & 1)) {      // a right child: merge up
                S += sh.stack[warp][lvl - TOP - 1][lane];
                orv |= sh.stack_or[warp][lvl - TOP - 1][lane];
                --lvl;
                idx >>= 1;
                cost_node<RICE2>(sh, t, row, L, P, N, order, escape, lvl,
                                 idx, S, orv);
            }
            if (lvl > top) {                      // a left child waits
                sh.stack[warp][lvl - TOP - 1][lane] = S;
                sh.stack_or[warp][lvl - TOP - 1][lane] = orv;
            } else {                              // the subtree's root
                sh.top[idx][lane] = S;
                sh.top_or[idx][lane] = orv;
            }
        }
    }
    __syncthreads();
    if (warp == 0) {
        for (int lvl = top - 1; lvl >= 0; --lvl) {
            for (int idx = 0; idx < (1 << lvl); ++idx) {
                const unsigned long long S =
                    sh.top[2 * idx][lane] + sh.top[2 * idx + 1][lane];
                const unsigned orv =
                    sh.top_or[2 * idx][lane] | sh.top_or[2 * idx + 1][lane];
                cost_node<RICE2>(sh, t, row, L, P, N, order, escape, lvl,
                                 idx, S, orv);
                sh.top[idx][lane] = S;
                sh.top_or[idx][lane] = orv;
            }
        }
    }
    __syncthreads();

    // the levels' bits, the RICE2 choice and the partition-order limits
    __shared__ unsigned char use5[LEVELS];
    if (threadIdx.x < L) {
        const int lvl = threadIdx.x;
        const bool valid = (N >> lvl) - order > 0;
        long long b4 = (long long)sh.total[0][lvl];
        b4 = valid ? (b4 < BIG ? b4 : BIG) : BIG;
        long long b = b4;
        bool r2 = false;
        if (RICE2) {
            long long b5 = (long long)sh.total[1][lvl];
            b5 = valid ? (b5 < BIG ? b5 : BIG) : BIG;
            r2 = b5 < b4;
            b = r2 ? b5 : b4;
        }
        const bool in_range = (N >> lvl) > order && lvl >= min_po;
        t.bits[row * L + lvl] = in_range ? (int)b + 2 + 4 : (int)BIG;
        t.rice2[row * L + lvl] = (unsigned char)r2;
        use5[lvl] = (unsigned char)r2;
    }
    if (RICE2) {
        __syncthreads();
        for (int e = threadIdx.x; e < L * P; e += THREADS) {
            const int lvl = e / P, idx = e - lvl * P;
            if (use5[lvl] && idx < (1 << lvl))
                t.ks[row * L * P + e] = t.ks5[row * L * P + e];
        }
    }
}

}  // namespace

extern "C" {

// K7 on `rows` rows of N int32 residuals (res [rows, N]) with their
// predictor orders (order [rows] int32): bits [rows, max_po + 1] int32,
// ks [rows, max_po + 1, 2^max_po] int32 and rice2 [rows, max_po + 1]
// bytes out; ks5, the 5-bit table's scratch of ks's shape, where rice2_mode
// (else unused).  All device pointers.  Returns the CUDA error code of the
// launch (0 on success).
int flac_rice_cost(const void* res, const void* order, void* bits, void* ks,
                   void* ks5, void* rice2, int rows, int N, int max_po,
                   int min_po, int rice2_mode, int escape, void* stream) {
    if (rows <= 0) return 0;
    if (max_po < 0 || max_po >= LEVELS || N <= 0 || N > (1 << 15)
            || (N >> max_po) << max_po != N || (rice2_mode && !ks5))
        return (int)cudaErrorInvalidValue;
    Tables t{(int*)bits, (int*)ks, (int*)ks5, (unsigned char*)rice2};
    if (rice2_mode)
        rice_cost_kernel<true><<<rows, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)res, (const int*)order, t, N, max_po, min_po,
            escape);
    else
        rice_cost_kernel<false><<<rows, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)res, (const int*)order, t, N, max_po, min_po,
            escape);
    return (int)cudaGetLastError();
}

}  // extern "C"
