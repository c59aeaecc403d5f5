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
// construction.
//
// Bit counts, not shifted sums.  For the zigzagged residuals u_i of a
// partition, S_k = sum_i (u_i >> k) = sum_{b >= k} c_b 2^(b - k), where c_b
// is how many u_i have bit b set: S_k = c_k + 2 S_(k+1).  A node of the
// partition tree needs only its 32 counts (a parent's are its children's
// added), the escape's raw width is the highest b with c_b > 0, plus 1,
// and one pass gives S_k for every k in 0..31, so RICE and RICE2 come from
// the same counts.  The cost n (k + 1) + S_k is convex in k: its step
// n - (S_k - S_(k+1)) = n - (c_k + S_(k+1)) never falls as k grows, so the
// first k whose step is >= 0 is the first argmin: one ballot a node finds
// both tables' parameters, and no reduction over k is needed.
//
// Design: one CTA of 4 warps a row.  A warp takes the subtree whose root
// is at level t = min(2, max_po), its quarter of the row.
//   count: the warp zigzags 32 residuals (one a lane), transposes their
//     32 x 32 bit matrix across the warp in five __shfl_xor_sync
//     butterfly rounds (a funnel-shift rotation and a bit select each),
//     and lane b adds the __popc of its word to c_b: 5 shuffles and ~15
//     other instructions per 32 samples.  Where a partition is a whole
//     number of such words, the warp loads and transposes GROUP = 8 words
//     at a time (8 independent chains), the next group's loads out before
//     the work on this one; else a chunk of up to 128 samples of one
//     partition at a time.
//   batched costing (max_po <= 6, the search of every preset: at most
//     127 nodes, one thread each): a partition's counts go to its node's
//     row in shared memory ([2P - 1][33] words), a right child's merged
//     into its parent's at once (lanes = b), the levels above the
//     subtrees after a barrier; then one thread a node runs S_b = c_b +
//     2 S_(b+1) from b = 31 down (32-bit while S_b < 2^31, b >= 17), with
//     k* and S_k* on the way, and writes the parameters; a warp's costs
//     are summed by level (__match_any_sync, __reduce_add_sync).  At -5 a
//     row's 63 nodes take 2 warps one pass of ~400 instructions, where a
//     warp a node would spend ~50 on each.
//   a warp a node (larger trees, up to 2^15 partitions): a 5-step shuffle
//     scan of a finished partition's counts gives lane k its E_k = S_(k+1)
//     (32-bit adds for four steps, 64-bit for the last); a node's state
//     is one 64-bit word a lane, E_k | c_k << 48 (E_k < 2^47 and c_k <=
//     2^15 for any node, so two states add as words); a ballot of c_k +
//     E_k <= n gives k*, the lane of each table's min(k*, kmax) computes
//     its cost, writes the parameter, and one shuffle brings the cost to
//     the lane of its level, which keeps the warp's level totals in a
//     register; a left child's state waits on a stack in shared memory
//     (one word a lane a level below the subtree's root, sized by the
//     launch), and above the subtrees the second of two sibling warps to
//     arrive (a shared atomic) merges them and goes on up.
// Then the level totals give the bits, the RICE2 choice (the 5-bit
// table's parameters are written to a scratch row first and copied over
// where it wins) and the limits.  Parameters past a level's 2^po
// partitions are 0.
//
// Bound on an H100: at -5 a batch is 64 x 4 x 6 rows of 4096 int32
// residuals, 25.2 MB read once, and ~1.2 MB of parameters and bits written:
// ~7.9 us of HBM time at 3.35 TB/s.  A launch takes ~2.8x that (-8: ~2.8x
// its 19.5 us): the transposes' chains of dependent shuffles, 8 in flight
// a warp, and the batched costing's serial recurrence set a CTA's pace,
// not its loads (a bulk copy of the row into shared memory, issued first,
// gained nothing); kernel_variants.py --k7 splits it.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TOP = 2;                  // subtree roots: level min(2, max_po)
constexpr int LEVELS = 16;              // partition orders 0..15
constexpr long long BIG = 1LL << 28;    // ops/rice.py BIG
constexpr int ESCAPE_K_BASE = 64;       // ops/rice.py ESCAPE_K_BASE
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int COUNT_SHIFT = 48;         // a state: E_k | c_k << 48
constexpr unsigned long long E_MASK = (1ULL << COUNT_SHIFT) - 1;
constexpr int BATCH_MAX_PO = 6;         // a tree of up to 127 nodes
static_assert(THREADS >= (2 << BATCH_MAX_PO) - 1,
              "the batched costing takes a thread a node");

struct Tables {
    int* bits;              // [rows, L]
    int* ks;                // [rows, L, P]
    int* ks5;               // [rows, L, P] scratch (RICE2 only)
    unsigned char* rice2;   // [rows, L]
};

struct Row {
    long long row;
    int L, P, N, order, escape;
};

// A lane's rotation and kept bits in each of the transpose's five rounds:
// round r pairs lanes l and l ^ j (j = 16 >> r); the lower lane keeps the
// bits b with (b & j) == 0 and takes the partner's rotated right by j
// into the others, the upper the reverse.
struct Butterfly {
    unsigned rot[5], keep[5];
    __device__ __forceinline__ explicit Butterfly(int lane) {
        const unsigned low[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                 0x33333333u, 0x55555555u};
#pragma unroll
        for (int r = 0; r < 5; ++r) {
            const int j = 16 >> r;
            const bool upper = (lane & j) != 0;
            rot[r] = upper ? j : 32 - j;   // rotate left by j, or right
            keep[r] = upper ? ~low[r] : low[r];
        }
    }
};

// The warp's 32 words as a 32 x 32 bit matrix, lane i's word its row i,
// transposed: lane b gets the word whose bit i is bit b of lane i's word.
__device__ __forceinline__ unsigned transpose32(unsigned x,
                                                const Butterfly& bf) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
        const unsigned y = __shfl_xor_sync(
            FULL, __funnelshift_l(x, x, bf.rot[r]), 16 >> r);
        x = (x & bf.keep[r]) | (y & ~bf.keep[r]);
    }
    return x;
}

__device__ __forceinline__ unsigned zigzag(int r) {
    return ((unsigned)r << 1) ^ (unsigned)(r >> 31);
}

// A finished partition's state from its bit counts (lane b holds c_b):
// lane k gets E_k | c_k << 48, E_k = S_(k+1) = sum_{b > k} c_b 2^(b-k-1).
// After four steps a lane's window holds 16 counts of at most 2^15 each
// under weights below 2^16, so 32 bits carry them; the last step widens.
__device__ __forceinline__ unsigned long long leaf_state(unsigned c,
                                                         int lane) {
    unsigned v = __shfl_down_sync(FULL, c, 1);
    if (lane == 31) v = 0;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
        const unsigned w = __shfl_down_sync(FULL, v, d);
        if (lane + d < 32) v += w << d;
    }
    const unsigned w = __shfl_down_sync(FULL, v, 16);
    unsigned long long e = v;
    if (lane < 16) e += (unsigned long long)w << 16;
    return e | ((unsigned long long)c << COUNT_SHIFT);
}

// Cost a finished node (level lvl, index idx, state st): each table's
// parameter to ks (ks5), its cost added to the lane of its level in tot4
// (tot5).
template <bool RICE2>
__device__ __forceinline__ void cost_node(const Tables& t, const Row& r,
                                          int lane, int lvl, int idx,
                                          unsigned long long st,
                                          unsigned long long& tot4,
                                          unsigned long long& tot5) {
    const long long c = (long long)(st >> COUNT_SHIFT);
    const long long e = (long long)(st & E_MASK);
    const long long n_eff = (long long)(r.N >> lvl)
                            - (idx == 0 ? r.order : 0);
    // S_k - S_(k+1) = c_k + E_k: the first k where it is <= n_eff is the
    // first argmin of n_eff (k + 1) + S_k (32: none, the cost falls to
    // the last k)
    const unsigned down = __ballot_sync(FULL, c + e <= n_eff);
    const int kstar = down ? __ffs(down) - 1 : 32;
    const int rawb = r.escape ? 32 - __clz(__ballot_sync(FULL, c != 0)) : 0;
    const long long cost0 = n_eff * (lane + 1) + c + 2 * e;
    const long long at = (r.row * r.L + lvl) * r.P + idx;
#pragma unroll
    for (int tb = 0; tb < (RICE2 ? 2 : 1); ++tb) {
        const int plen = tb ? 5 : 4;
        const int kb = min(kstar, tb ? 30 : 14);
        const long long cost = cost0 + plen;
        long long best = cost < BIG ? cost : BIG;
        int param = lane;
        if (r.escape) {
            const long long esc = n_eff * rawb + plen + 5;
            if (esc < best) {
                best = esc;
                param = ESCAPE_K_BASE + rawb;
            }
        }
        if (lane == kb) (tb ? t.ks5 : t.ks)[at] = param;
        // best <= BIG, and >= -31 * 32 on a level that keeps no sample
        const int bv = __shfl_sync(FULL, (int)best, kb);
        if (lane == lvl)
            (tb ? tot5 : tot4) += (unsigned long long)(long long)bv;
    }
}

// One chunk of a partition: up to 4 x 32 samples from src, one load a
// lane each, all issued together (lanes past n load nothing).
__device__ __forceinline__ void load_chunk(int (&v)[4],
                                           const int* __restrict__ src,
                                           int n, int lane) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
        v[j] = 32 * j + lane < n ? __ldg(src + 32 * j + lane) : 0;
}

// The bit counts of a chunk's n samples (0 sets no bit).
__device__ __forceinline__ unsigned count_chunk(const int (&v)[4], int n,
                                                const Butterfly& bf) {
    unsigned c = __popc(transpose32(zigzag(v[0]), bf));
#pragma unroll
    for (int j = 1; j < 4; ++j)
        if (32 * j < n) c += __popc(transpose32(zigzag(v[j]), bf));
    return c;
}

// Words w0..w0+GROUP-1 of a warp's share (32 samples each, lane l the
// l-th of each), those below W.
template <int GROUP>
__device__ __forceinline__ void load_words(int (&v)[GROUP],
                                           const int* __restrict__ src,
                                           int w0, int W) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
        v[j] = w0 + j < W ? __ldg(src + 32 * (w0 + j)) : 0;
}

// Words of dynamic shared memory for the BATCH tree: every node's 32
// counts, [2P - 1][33] (33: one thread a node reads its row's counts
// with no bank conflict).
__host__ __device__ __forceinline__ int tree_words(int max_po) {
    return ((2 << max_po) - 1) * 33;
}

// BATCH: partition p's counts (lane b: c_b) to its node's row, then, while
// it is a right child, its parent's (its own added to its left sibling's),
// up to the subtree's root.
__device__ __forceinline__ void push_counts(unsigned* cnt, int max_po,
                                            int top_lvl, int p, unsigned c,
                                            int lane) {
    int lvl = max_po, idx = p;
    cnt[((1 << lvl) - 1 + idx) * 33 + lane] = c;
    while (lvl > top_lvl && (idx & 1)) {
        c += cnt[((1 << lvl) - 2 + idx) * 33 + lane];
        --lvl;
        idx >>= 1;
        cnt[((1 << lvl) - 1 + idx) * 33 + lane] = c;
    }
}

// Cost node j of a row's tree (level lvl, index idx) from its 32 bit
// counts c[0..31], one thread a node: S_b = c_b + 2 S_(b+1) from b = 31
// down, k* the smallest b with c_b + S_(b+1) <= n_eff.  Writes each
// table's parameter and returns its cost (clamped, or the escape's).
template <bool RICE2>
__device__ __forceinline__ void cost_counts(const Tables& t, const Row& r,
                                            const unsigned* c, int lvl,
                                            int idx, int (&best)[2]) {
    const long long n_eff = (long long)(r.N >> lvl)
                            - (idx == 0 ? r.order : 0);
    // S_b <= 2^15 (2^(32 - b) - 1) < 2^31 for b >= 17: 32-bit steps there
    const int n32 = (int)n_eff;
    int s32 = 0, sk32 = 0, s30 = 0;
    int kstar = 32, rawb = 0;
#pragma unroll
    for (int b = 31; b >= 17; --b) {
        const int cb = (int)c[b];
        const int sb = cb + 2 * s32;                  // S_b
        if (cb + s32 <= n32) {
            kstar = b;
            sk32 = sb;
        }
        if (RICE2 && b == 30) s30 = sb;
        if (rawb == 0 && cb != 0) rawb = b + 1;
        s32 = sb;
    }
    long long s = s32, sk = sk32, s14 = 0;
#pragma unroll
    for (int b = 16; b >= 0; --b) {
        const long long cb = c[b];
        const long long sb = cb + 2 * s;              // S_b
        if (cb + s <= n_eff) {
            kstar = b;
            sk = sb;
        }
        if (b == 14) s14 = sb;
        if (rawb == 0 && cb != 0) rawb = b + 1;
        s = sb;
    }
    const long long at = (r.row * r.L + lvl) * r.P + idx;
#pragma unroll
    for (int tb = 0; tb < (RICE2 ? 2 : 1); ++tb) {
        const int kmax = tb ? 30 : 14, plen = tb ? 5 : 4;
        const int k = min(kstar, kmax);
        const long long s_k = kstar <= kmax ? sk : (tb ? s30 : s14);
        const long long cost = n_eff * (k + 1) + s_k + plen;
        long long b = cost < BIG ? cost : BIG;
        int param = k;
        if (r.escape) {
            const long long esc = n_eff * rawb + plen + 5;
            if (esc < b) {
                b = esc;
                param = ESCAPE_K_BASE + rawb;
            }
        }
        (tb ? t.ks5 : t.ks)[at] = param;
        best[tb] = (int)b;
    }
}

// BATCH (max_po <= BATCH_MAX_PO): the nodes' bit counts go to shared
// memory and one thread a node costs them (cost_counts); where a partition
// is a whole number of 32-sample words, a warp counts GROUP words at a
// time (GROUP independent transposes), else a chunk of a partition at a
// time.  Else a warp costs each node as it is finished (cost_node), with
// a stack of left children's states.
template <bool RICE2, bool BATCH>
__global__ void __launch_bounds__(THREADS) rice_cost_kernel(
        const int* __restrict__ res, const int* __restrict__ order_in,
        Tables t, int N, int max_po, int min_po, int escape) {
    constexpr int GROUP = 8;
    // BATCH: every node's counts, [2P - 1][33]; else a left child's state
    // until its sibling is done, [WARPS][depth][32]
    extern __shared__ unsigned long long dyn[];
    // (not BATCH) the states of the nodes at levels 0..TOP, in heap
    // order, and how many children of each node above TOP have arrived
    __shared__ unsigned long long up[(2 << TOP) - 1][32];
    __shared__ int arrived[(1 << TOP) - 1];
    __shared__ unsigned long long wtot[2][WARPS][LEVELS];
    __shared__ unsigned char use5[LEVELS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Row r{(long long)blockIdx.x, max_po + 1, 1 << max_po, N,
                order_in[blockIdx.x], escape};
    const int L = r.L, P = r.P;
    const long long row = r.row;
    unsigned* cnt = reinterpret_cast<unsigned*>(dyn);   // BATCH
    // parameters past each level's partitions are 0, in both tables
    for (int e = threadIdx.x; e < L * P; e += THREADS) {
        const int lvl = e >> max_po, idx = e & (P - 1);
        if (idx >= (1 << lvl)) {
            t.ks[row * L * P + e] = 0;
            if (RICE2) t.ks5[row * L * P + e] = 0;
        }
    }
    if (threadIdx.x < (1 << TOP) - 1) arrived[threadIdx.x] = 0;
    for (int i = threadIdx.x; i < 2 * WARPS * LEVELS; i += THREADS)
        (&wtot[0][0][0])[i] = 0;
    __syncthreads();

    const int top_lvl = max_po < TOP ? max_po : TOP;
    const int depth = max_po - top_lvl;      // levels below a subtree root
    const int m = N >> max_po;               // samples a finest partition
    const int* rrow = res + row * (long long)N;
    unsigned long long tot4 = 0, tot5 = 0;   // lane lvl: level lvl's total
    const int first = warp << depth, end = first + (1 << depth);
    if (warp < (1 << top_lvl) && BATCH && (m & 31) == 0) {
        // the subtree's W words, GROUP at a time, each group's loads out
        // before the work on the one before it
        const Butterfly bf(lane);
        const int W = (m >> 5) << depth, wpl = m >> 5;
        const int* src = rrow + (long long)first * m + lane;
        int nxt[GROUP];
        load_words<GROUP>(nxt, src, 0, W);
        int p = first, in_p = 0;
        unsigned c = 0;
        for (int w0 = 0; w0 < W; w0 += GROUP) {
            int cur[GROUP];
#pragma unroll
            for (int j = 0; j < GROUP; ++j) cur[j] = nxt[j];
            if (w0 + GROUP < W)
                load_words<GROUP>(nxt, src, w0 + GROUP, W);
            unsigned x[GROUP];
#pragma unroll
            for (int j = 0; j < GROUP; ++j) x[j] = transpose32(zigzag(cur[j]),
                                                              bf);
#pragma unroll
            for (int j = 0; j < GROUP; ++j) {
                if (w0 + j >= W) break;
                c += __popc(x[j]);
                if (++in_p == wpl) {                 // partition p is counted
                    push_counts(cnt, max_po, top_lvl, p, c, lane);
                    c = 0;
                    in_p = 0;
                    ++p;
                }
            }
        }
    } else if (warp < (1 << top_lvl)) {
        const Butterfly bf(lane);
        unsigned long long* stk = dyn + (size_t)warp * depth * 32 + lane;
        // the subtree's partitions in chunks of up to 128 samples; each
        // chunk's loads go out before the work on the one before it
        const int csz = m < 128 ? m : 128;
        int nxt[4];
        load_chunk(nxt, rrow + (long long)first * m, csz, lane);
        int p = first, off = 0;
        unsigned c = 0;
        unsigned long long st = 0;
        while (true) {
            const int cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
            const int n = min(csz, m - off);
            int np = p, noff = off + csz;
            if (noff >= m) {
                noff = 0;
                ++np;
            }
            if (np < end)
                load_chunk(nxt, rrow + (long long)np * m + noff,
                           min(csz, m - noff), lane);
            c += count_chunk(cur, n, bf);
            if (BATCH && noff == 0) {             // partition p is counted
                push_counts(cnt, max_po, top_lvl, p, c, lane);
                c = 0;
            } else if (noff == 0) {
                st = leaf_state(c, lane);
                c = 0;
                int lvl = max_po, idx = p;
                cost_node<RICE2>(t, r, lane, lvl, idx, st, tot4, tot5);
                while (lvl > top_lvl && (idx & 1)) {  // a right child
                    st += stk[(lvl - top_lvl - 1) * 32];
                    --lvl;
                    idx >>= 1;
                    cost_node<RICE2>(t, r, lane, lvl, idx, st, tot4, tot5);
                }
                if (lvl > top_lvl)                // a left child waits
                    stk[(lvl - top_lvl - 1) * 32] = st;
            }
            if (np >= end) break;
            p = np;
            off = noff;
        }
        // st is the subtree root's.  Above it, the second of two siblings
        // to arrive merges them and goes on up; the first stops.
        int lvl = top_lvl, idx = warp;
        while (!BATCH && lvl > 0) {
            up[(1 << lvl) - 1 + idx][lane] = st;
            __syncwarp();
            int second = 0;
            if (lane == 0) {
                __threadfence_block();
                second = atomicAdd(&arrived[(1 << (lvl - 1)) - 1 + (idx >> 1)],
                                   1);
                __threadfence_block();
            }
            second = __shfl_sync(FULL, second, 0);
            if (!second) break;
            __syncwarp();
            st += ((volatile unsigned long long*)
                   up[(1 << lvl) - 1 + (idx ^ 1)])[lane];
            --lvl;
            idx >>= 1;
            cost_node<RICE2>(t, r, lane, lvl, idx, st, tot4, tot5);
        }
    }
    if (BATCH) {
        __syncthreads();
        // the counts of the levels above the subtrees, then every node's
        // costs, a thread a node; a warp's costs summed by level
        // (__match_any_sync groups its lanes by level; the sum in 16-bit
        // halves, as __reduce_add_sync adds 32-bit values)
        if (warp == 0)
            for (int lvl = top_lvl - 1; lvl >= 0; --lvl)
                for (int idx = 0; idx < (1 << lvl); ++idx)
                    cnt[((1 << lvl) - 1 + idx) * 33 + lane] =
                        cnt[((2 << lvl) - 1 + 2 * idx) * 33 + lane]
                        + cnt[((2 << lvl) + 2 * idx) * 33 + lane];
        __syncthreads();
        const int j = threadIdx.x;
        if (warp * 32 < 2 * P - 1) {
            const bool node = j < 2 * P - 1;
            const int lvl = node ? 31 - __clz(j + 1) : LEVELS;
            int best[2] = {0, 0};
            if (node)
                cost_counts<RICE2>(t, r, cnt + j * 33, lvl,
                                   j + 1 - (1 << lvl), best);
            const unsigned grp = __match_any_sync(FULL, lvl);
#pragma unroll
            for (int tb = 0; tb < (RICE2 ? 2 : 1); ++tb) {
                const int hi = __reduce_add_sync(grp, best[tb] >> 16);
                const unsigned lo = __reduce_add_sync(
                    grp, (unsigned)best[tb] & 0xFFFFu);
                if (node && lane == __ffs(grp) - 1)
                    wtot[tb][warp][lvl] = (unsigned long long)(
                        (long long)hi * 65536 + lo);
            }
        }
    } else if (lane < LEVELS) {
        wtot[0][warp][lane] = tot4;
        wtot[1][warp][lane] = tot5;
    }
    __syncthreads();

    // the levels' bits, the RICE2 choice and the partition-order limits
    if (threadIdx.x < L) {
        const int lvl = threadIdx.x;
        long long s4 = 0, s5 = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            s4 += (long long)wtot[0][w][lvl];
            s5 += (long long)wtot[1][w][lvl];
        }
        const bool valid = (N >> lvl) - r.order > 0;
        const long long b4 = valid ? (s4 < BIG ? s4 : BIG) : BIG;
        long long b = b4;
        bool r2 = false;
        if (RICE2) {
            const long long b5 = valid ? (s5 < BIG ? s5 : BIG) : BIG;
            r2 = b5 < b4;
            b = r2 ? b5 : b4;
        }
        const bool in_range = (N >> lvl) > r.order && lvl >= min_po;
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
    const int depth = max_po - (max_po < TOP ? max_po : TOP);
    const bool batch = max_po <= BATCH_MAX_PO;
    const size_t smem = batch ? (size_t)tree_words(max_po) * 4
                              : (size_t)WARPS * depth * 32 * 8;
    auto launch = [&](auto kernel) {
        kernel<<<rows, THREADS, smem, (cudaStream_t)stream>>>(
            (const int*)res, (const int*)order, t, N, max_po, min_po,
            escape);
    };
    if (rice2_mode)
        batch ? launch(rice_cost_kernel<true, true>)
              : launch(rice_cost_kernel<true, false>);
    else
        batch ? launch(rice_cost_kernel<false, true>)
              : launch(rice_cost_kernel<false, false>);
    return (int)cudaGetLastError();
}

}  // extern "C"
