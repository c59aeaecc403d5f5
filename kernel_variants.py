#!/usr/bin/env python3
"""Where the time of kernels K1-K8, K10 and K11 goes, on one NVIDIA GPU.

    python3 kernel_variants.py            # every variant of every kernel
    python3 kernel_variants.py --k1       # K1's only (or --k2 ... --k8,
                                          # --k10, --k11; several may be
                                          # given)
    python3 kernel_variants.py --other "old=DIR"  # and DIR/*.cu as they are
    python3 kernel_variants.py --k11 --other "old=DIR" --pairs 10
                                          # and K8/K10/K11 against DIR's in
                                          # 10 alternating pairs
    python3 kernel_variants.py --k8 --sass DIR \
        --sass-kernel candidate_residuals_kernelIiLb0E
                                          # and the SASS of K8's narrow
                                          # forms ("i32", "f64"), a file
                                          # a variant

Each variant is the kernel's source with one change (a constant, a part of
the work cut out or moved, or timestamps), built by nvcc into a library of
its own under flac_tpu_torch/build/variants/ and timed at the main path's
shapes: K1 on a -5 batch's fields (64 frames of 2263 fields into 8192
words), K2 on the first full decode batch of a 100 s -5 stream (65,536
lanes of 128 codes), K3 on the same batch's residuals (2048 subframes of
4096 samples, int16 out) as each engine gives them: int32 (the device
engine) and int16 (the fast engine), K4 on the field lists of the
track's first 64 frames at -5 and of its first 256 (the sharded form's
batch), K5 on the packed words of the same 64 and 256 frames (each launch
on a fresh copy: it seals in place), K6 and K7 on the search inputs of the
track's first 64 frames at -5 (K6: 256 problems of order 8; K7: 1536 rows)
and at -8 (2304 problems of order 12; 3584 rows), K10 and K11 on the
same frames' front of the search as chip_smoke.py phase 6 takes it (K10:
the -5 batch uploaded as int16; K11: the -5 and -8 rows, windows and
combine) and on the -5 batch four times over (256 frames, the sharded
form's batch; K10 on int32), K8 on the candidate residuals' arguments
of 64 frames of the track at -5 and -8, of 24-bit 96 kHz stereo at -8
("f64") and of 24-bit 5.1 at -5 (chip_smoke.py's HIRES), each variant's
output held against the plain version (`same_as_plain`) before it is
timed.  K8's --other versions also get the variants of the design
before this one (K8_PARENT_VARIANTS) where their edits apply.  Before K3's variants,
a one-thread
probe times the recursion's chain (cycles a sample, generic and folded,
and the SM clock); each K3 line carries the chain floor it gives,
N x cycles / clock.  A variant that cuts work out
computes a wrong result; it is timed only.  `ms` is the device time of one launch
(torch.profiler over 50 launches), taken in turns with the unchanged
kernel ("base") so drift shows.  A "phases" variant also reports, from
one more launch, each CTA's clock64() at numbered points of the kernel
(see PHASE_DEFS and each kernel's phase list).  `--other` times another
version of a source (another commit's csrc/, say) beside them, through
the same C entry point.  Prints one JSON line a variant and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "flac_tpu_torch" / "csrc"
OUT = HERE / "flac_tpu_torch" / "build" / "variants"

# A "phases" variant records clock64() at numbered points of each CTA
# (thread 0's view; PHMAX: the last warp's) and %globaltimer at the CTA's
# start and end; after its timing the script prints where a CTA's cycles go.
PHASE_SLOTS = 10        # per CTA: points 0-7 in cycles, 8-9 globaltimer ns
PHASE_DEFS = r"""
__device__ long long g_ph[65536 * 10];
__device__ __forceinline__ long long gtimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define PH(k) do { if (threadIdx.x == 0) \
    g_ph[blockIdx.x * 10 + (k)] = clock64(); } while (0)
#define PHMAX(k) do { if ((threadIdx.x & 31) == 0) { \
    atomicMax((unsigned long long*)&g_ph[blockIdx.x * 10 + (k)], \
              (unsigned long long)clock64()); \
    atomicMax((unsigned long long*)&g_ph[blockIdx.x * 10 + 9], \
              (unsigned long long)gtimer()); } } while (0)
#define PHSTART() do { if (threadIdx.x == 0) { \
    g_ph[blockIdx.x * 10 + 8] = gtimer(); \
    g_ph[blockIdx.x * 10] = clock64(); } } while (0)
"""
PHASE_TAIL = r"""
extern "C" int flac_phases(void* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, g_ph, n * sizeof(long long));
}
extern "C" int flac_phases_clear(int n) {
    void* p;
    const cudaError_t e = cudaGetSymbolAddress(&p, g_ph);
    return e ? (int)e : (int)cudaMemset(p, 0, n * sizeof(long long));
}
"""

K1_PHASES = [
    ("namespace {\n", "namespace {\n" + PHASE_DEFS),
    ("    __shared__ int share_neg[CLUSTER];\n",
     "    __shared__ int share_neg[CLUSTER];\n    PHSTART();\n"),
    ("    neg = __syncthreads_or(neg);\n",
     "    neg = __syncthreads_or(neg);\n    PH(1);\n"),
    ("        asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n",
     "        asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
     "    PH(2);\n"),
    ("    cluster_barrier();\n\n    // 2.",
     "    cluster_barrier();\n    PH(3);\n\n    // 2."),
    ("                min(W, used + (rank + 1) * zper));\n",
     "                min(W, used + (rank + 1) * zper));\n    PH(4);\n"),
    ("        cluster_barrier();               // every contribution has landed\n",
     "        PH(5);\n        cluster_barrier();\n        PH(6);\n"),
    ("        store_words(out, first, tile, lo, lo, min(used, lo + own));\n    }\n",
     "        store_words(out, first, tile, lo, lo, min(used, lo + own));\n    }\n"
     "    PHMAX(7);\n"),
    ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]
# the zero words past `used` stored after the last cluster barrier, so
# that no barrier's release waits for their stores
K1_ZEROS_LAST = [
    ("    store_words(out, first, nullptr, 0, used + rank * zper,\n"
     "                min(W, used + (rank + 1) * zper));\n", ""),
    ("        store_words(out, first, tile, lo, lo, min(used, lo + own));\n"
     "    }\n",
     "        store_words(out, first, tile, lo, lo, min(used, lo + own));\n"
     "    }\n"
     "    store_words(out, first, nullptr, 0, used + rank * zper,\n"
     "                min(W, used + (rank + 1) * zper));\n")]

# (name, [(old, new), ...]): each old text must occur in the source
K1_VARIANTS = [
    ("base", []),
    ("no deposit", [("if (pb <= 0) continue;", "continue;")]),
    ("launch only", [("    const int rank = (int)cluster.block_rank();",
                      "    if (S > 0) return;\n"
                      "    const int rank = (int)cluster.block_rank();")]),
    ("zeros first", [
        ("        f.load(nzeros, payload, pbits, row, f0 + tid * FPT, f1, true);\n",
         "        f.load(nzeros, payload, pbits, row, f0 + tid * FPT, f1, true);\n"
         "        { const int zh = ((W + CLUSTER - 1) / CLUSTER + 1) & ~1;\n"
         "          store_words(words + (size_t)b * W, (size_t)b * W, nullptr, 0,\n"
         "                      min(W, rank * zh), min(W, (rank + 1) * zh)); }\n"),
        ("    store_words(out, first, nullptr, 0, used + rank * zper,\n"
         "                min(W, used + (rank + 1) * zper));\n", "")]),
    ("phases", K1_PHASES),
    ("zeros last", K1_ZEROS_LAST),
    ("zeros last, phases", K1_ZEROS_LAST + K1_PHASES),
]
K2_VARIANTS = [
    ("base", []),
    ("global path", [("const bool staged = span <= STAGE_ROWS;",
                      "const bool staged = false;")]),
    ("no stores", [
        ("                *out = val;\n",
         "                if (val == 0x7fffffff) *out = val;\n"),
        ("        *out = val;\n        out += L;\n        --rem;\n    }",
         "        if (val == 0x7fffffff) *out = val;\n        out += L;\n"
         "        --rem;\n    }")]),
    ("stage only", [("for (int t = 0; t < T; ++t) {",
                     "for (int t = 0; t < 0; ++t) {")]),
    # the first half (quarter) of the lanes only: the same time means each
    # warp's serial chain sets the pace, half the time that the SM's
    # instruction throughput does
    ("half the lanes", [("const int blocks = (L + THREADS - 1) / THREADS;",
                         "const int blocks = (L / 2 + THREADS - 1) / THREADS;")]),
    ("a quarter of the lanes", [
        ("const int blocks = (L + THREADS - 1) / THREADS;",
         "const int blocks = (L / 4 + THREADS - 1) / THREADS;")]),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ int warp_lo[NWARPS], warp_hi[NWARPS];\n",
         "    __shared__ int warp_lo[NWARPS], warp_hi[NWARPS];\n    PHSTART();\n"),
        ("    const bool staged = span <= STAGE_ROWS;\n",
         "    const bool staged = span <= STAGE_ROWS;\n    PH(1);\n"),
        ("        if (threadIdx.x == 0) atomicAdd(&g_staged_ctas, 1ull);\n    }\n",
         "        if (threadIdx.x == 0) atomicAdd(&g_staged_ctas, 1ull);\n    }\n"
         "    PH(2);\n"),
        ("    ovf_out[lane] = ovf ? 1 : 0;\n",
         "    ovf_out[lane] = ovf ? 1 : 0;\n    PH(3);\n    PHMAX(4);\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
]


K3_WAITS = ("        bar_wait(full_in + 8 * ist, (c / IN_STAGES) & 1);\n"
            "        bar_wait(empty_out + 8 * ost, ((c / OUT_STAGES) & 1) ^ 1);\n")
K3_ARRIVES = ("        bar_arrive(empty_in + 8 * (c % IN_STAGES));\n"
              "        bar_arrive(full_out + 8 * (c % OUT_STAGES));\n")
K3_ADVANCE = "        ++c;\n        u0 = 0;\n        if (c < nch) acquire();\n"
K3_ROLES = "    if (warp == 0) {\n        recurse<MO, WIDE>"
# the recursion warp alone, its residuals made up in registers: no
# producer, no epilogue, no barrier
K3_ALONE = [
    (K3_WAITS, ""), (K3_ARRIVES, ""),
    ("    auto load = [&]() { load_round<R, XT>(r, src, rb, u0); };",
     "    auto load = [&]() {\n#pragma unroll\n"
     "        for (int u = 0; u < R; ++u)\n"
     "            r[u] = (XT)(c * K + u0 + u + lane);\n    };"),
    (K3_ROLES, "    if (warp != 0) return;\n" + K3_ROLES)]
# the folded form's chain only (a wrong result): none of the MO - 1 older
# taps' FP64 multiply-adds
K3_NO_TAPS = [("            for (int j = 1; j < MO; ++j) {",
               "            for (int j = 1; j < 1; ++j) {")]
K3_VARIANTS = [
    ("base", []),
    ("chain only", K3_ALONE),
    ("no off-chain taps", K3_NO_TAPS),
    # both: the probe's work (a funnel shift, a multiply-add and the fold
    # a sample) in the kernel's loop
    ("bare chain", K3_ALONE + K3_NO_TAPS),
    # the folded chain's step by mad.wide.s32 (ptxas: a product and two
    # adds) instead of the carry chain
    ("mad.wide chain", [("        V = mad_cc(q0, x, C);",
                         "        V = mad_wide(q0, x, C);")]),
    # every round in the generic form (int64 multiply-adds for every tap,
    # as before the folded form moved the older taps to the FP64 pipe)
    ("generic form", [("        if (folded && !warm) break;",
                       "        if (folded && !warm && c < 0) break;")]),
    # the residuals not folded into the sums (a wrong result): the cost of
    # r << sh and its add on the recursion warp
    ("no fold", [("        const long long rs = u + 2 < R ? "
                  "fold(r[u + 2 < R ? u + 2 : 0], sh)\n"
                  "                                       : 0;",
                  "        const long long rs = 0;")]),
    # the epilogue warps wait and release the x ring and do nothing else
    ("no epilogue", [("            if (pass >= passes) break;\n"
                      "            const int slot = first + 8 * pass;",
                      "            if (pass >= passes || c >= 0) break;\n"
                      "            const int slot = first + 8 * pass;")]),
    ("ring depth 2", [("constexpr int IN_STAGES = 3;",
                       "constexpr int IN_STAGES = 2;")]),
    # clock64 per role: 1 the recursion's first chunk in, 2 its end, 3 the
    # producer's end, 4 the epilogue's end (the later warp); 5 and 6 the
    # recursion's cycles waiting for residuals and for a free x stage
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __syncthreads();\n" + K3_ROLES,
         "    __syncthreads();\n    PHSTART();\n" + K3_ROLES),
        ("    int c = 0, u0 = 0;\n",
         "    int c = 0, u0 = 0;\n    long long w_in = 0, w_out = 0;\n"),
        (K3_WAITS,
         "        long long t = clock64();\n"
         "        bar_wait(full_in + 8 * ist, (c / IN_STAGES) & 1);\n"
         "        w_in += clock64() - t;\n"
         "        if (c == 0) PH(1);\n"
         "        t = clock64();\n"
         "        bar_wait(empty_out + 8 * ost, ((c / OUT_STAGES) & 1) ^ 1);\n"
         "        w_out += clock64() - t;\n"),
        (K3_ADVANCE,
         K3_ADVANCE + "        if (c == nch) {\n"
         "            PH(2);\n"
         "            if (threadIdx.x == 0) {\n"
         "                long long* ph = g_ph + blockIdx.x * 10;\n"
         "                ph[5] = ph[0] + w_in;\n"
         "                ph[6] = ph[0] + w_out;\n"
         "            }\n"
         "        }\n"),
        ("        bar_arrive(full + 8 * st);\n    }\n}\n",
         "        bar_arrive(full + 8 * st);\n    }\n"
         "    if (lane == 0) g_ph[blockIdx.x * 10 + 3] = clock64();\n}\n"),
        ("    // one store of 1 a flagged slot",
         "    PHMAX(4);\n    // one store of 1 a flagged slot"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
]

# K4: clock64 at 1 the channel scalars in, 2 the slots stored (the last
# warp), 3 every CTA of the cluster running, 4 the shares pushed to rank 0
# (the cluster barrier), 7 the end (rank 0's outputs)
K4_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ Smem sh;\n",
         "    __shared__ Smem sh;\n    PHSTART();\n"),
        ("                       ? a.N >> po : 0;\n    }\n    __syncthreads();\n",
         "                       ? a.N >> po : 0;\n    }\n    __syncthreads();\n"
         "    PH(1);\n"),
        ("    // the share's bit total and fit flag: warps, then the CTA, then rank 0\n",
         "    PHMAX(2);\n"),
        ("    cluster_wait();\n    if (threadIdx.x == 0) {\n",
         "    cluster_wait();\n    PH(3);\n    if (threadIdx.x == 0) {\n"),
        ("    cluster_barrier();\n    if (rank == 0 && threadIdx.x == 0) {\n",
         "    cluster_barrier();\n    PH(4);\n"
         "    if (rank == 0 && threadIdx.x == 0) {\n"),
        ("                         + a.bs_tail_bits / 8 + a.sr_tail_bits / 8;\n"
         "    }\n}\n",
         "                         + a.bs_tail_bits / 8 + a.sr_tail_bits / 8;\n"
         "    }\n    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # other cluster sizes: at most 4 or 2 CTAs a frame, one CTA a frame
    # (the frame's slots in one CTA, as before clusters, with this
    # source's loads and reductions), and 8 whatever the batch
    ("at most 4 a frame", [("constexpr int CLUSTER = 8;",
                            "constexpr int CLUSTER = 4;")]),
    ("at most 2 a frame", [("constexpr int CLUSTER = 8;",
                            "constexpr int CLUSTER = 2;")]),
    ("a CTA a frame", [("constexpr int CLUSTER = 8;",
                        "constexpr int CLUSTER = 1;")]),
    ("8 a frame always", [("constexpr int CTA_TARGET = 512;",
                           "constexpr int CTA_TARGET = 1 << 30;")]),
    ("128 threads", [("constexpr int THREADS = 256;",
                      "constexpr int THREADS = 128;")]),
]
K7_NODE_CALL = "cost_node<RICE2>(t, r, lane, lvl, idx, st, tot4, tot5);"
# K7 (the batched path on words, the main path's): thread 0 (warp 0)
# keeps its cycles in the groups' transposes (2) and in the partitions'
# count stores and merges (3), from the CTA's start; 1 the walk starts
# (the zero fill done), 4 thread 0's walk done, 6 the costs summed (the
# batched costing done), 7 the end (the last warp's stores)
K7_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ unsigned char use5[LEVELS];\n",
         "    __shared__ unsigned char use5[LEVELS];\n    PHSTART();\n"
         "    long long t_cnt = 0, t_node = 0;\n"),
        ("    if (warp < (1 << top_lvl) && BATCH && (m & 31) == 0) {\n",
         "    PH(1);\n    if (warp < (1 << top_lvl) && BATCH && (m & 31) == 0) {\n"),
        ("            unsigned x[GROUP];\n",
         "            const long long t0 = clock64();\n"
         "            unsigned x[GROUP];\n"),
        ("                if (++in_p == wpl) {                 // partition p is counted\n",
         "                if (j == 0) t_cnt += clock64() - t0;\n"
         "                if (++in_p == wpl) {                 // partition p is counted\n"),
        ("                    push_counts(cnt, max_po, top_lvl, p, c, lane);\n"
         "                    c = 0;\n                    in_p = 0;\n",
         "                    const long long t1 = clock64();\n"
         "                    push_counts(cnt, max_po, top_lvl, p, c, lane);\n"
         "                    t_node += clock64() - t1;\n"
         "                    c = 0;\n                    in_p = 0;\n"),
        ("    if (BATCH) {\n        __syncthreads();\n",
         "    if (threadIdx.x == 0) {\n"
         "        g_ph[blockIdx.x * 10 + 2] = g_ph[blockIdx.x * 10] + t_cnt;\n"
         "        g_ph[blockIdx.x * 10 + 3] = g_ph[blockIdx.x * 10] + t_node;\n"
         "    }\n    PH(4);\n"
         "    if (BATCH) {\n        __syncthreads();\n"),
        ("    // the levels' bits, the RICE2 choice and the partition-order limits\n",
         "    PH(6);\n"),
        ("                t.ks[row * L * P + e] = t.ks5[row * L * P + e];\n"
         "        }\n    }\n}\n",
         "                t.ks[row * L * P + e] = t.ks5[row * L * P + e];\n"
         "        }\n    }\n    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # the counts alone (a wrong result): no leaf scan, no node cost
    ("counts only", [(K7_NODE_CALL, ""),
                     ("                st = leaf_state(c, lane);\n",
                      "                st = c;\n"),
                     ("            if (node)\n                cost_counts<RICE2>(",
                      "            if (false)\n                cost_counts<RICE2>(")]),
    # a warp a node as it is finished at every max_po (no batched costing)
    ("no batch", [("    const bool batch = max_po <= BATCH_MAX_PO;",
                   "    const bool batch = false;")]),
    # no transposes (a wrong result): the loads and the tree only
    ("no transposes", [
        ("            for (int j = 0; j < GROUP; ++j) x[j] = transpose32(zigzag(cur[j]),\n"
         "                                                              bf);\n",
         "            for (int j = 0; j < GROUP; ++j) x[j] = cur[j];\n")]),
    # a group of 4 or 16 words at a time
    ("groups of 4", [("    constexpr int GROUP = 8;", "    constexpr int GROUP = 4;")]),
    ("groups of 16", [("    constexpr int GROUP = 8;", "    constexpr int GROUP = 16;")]),
    ("8 warps a row", [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
                       ("constexpr int TOP = 2; ", "constexpr int TOP = 3; ")]),
    # at most 40 registers: 12 CTAs an SM in place of 8
    ("12 CTAs an SM", [("__launch_bounds__(THREADS) rice_cost_kernel",
                        "__launch_bounds__(THREADS, 12) rice_cost_kernel")]),
]

# K5: clock64 at 4 the frame's lengths in (thread 0), 1 the loads issued
# and the tables in shared memory, 5 thread 0's first pairs in, 2 its
# column's Horner done, 3 the CTA's remainder (warp 0's tree), 6 every
# rank past the cluster barrier, 7 the end (rank 0's deposits)
K5_SLICING = (
    "    return (sh.slice[7][hi >> 24] ^ sh.slice[6][(hi >> 16) & 0xFFu])\n"
    "         ^ (sh.slice[5][(hi >> 8) & 0xFFu] ^ sh.slice[4][hi & 0xFFu])\n"
    "         ^ (sh.slice[3][lo >> 24] ^ sh.slice[2][(lo >> 16) & 0xFFu])\n"
    "         ^ (sh.slice[1][(lo >> 8) & 0xFFu] ^ sh.slice[0][lo & 0xFFu]);\n")
K5_BYTE_STEPS = (
    "    unsigned c = 0;\n#pragma unroll\n"
    "    for (int k = 0; k < 8; ++k) {\n"
    "        const unsigned byte = ((k < 4 ? hi : lo) >> (24 - 8 * (k & 3)))\n"
    "                              & 0xFFu;\n"
    "        c = ((c << 8) & 0xFFFFu) ^ sh.slice[0][(c >> 8) ^ byte];\n"
    "    }\n    return c;\n")
K5_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ __align__(16) Smem sh;\n",
         "    __shared__ __align__(16) Smem sh;\n    PHSTART();\n"),
        ("    __syncthreads();\n\n    // 2. the CRC-8",
         "    __syncthreads();\n    PH(1);\n\n    // 2. the CRC-8"),
        ("    // 4. the columns", "    PH(2);\n    // 4. the columns"),
        ("    // 5. each rank's", "    PH(3);\n    // 5. each rank's"),
        ("    cluster_barrier();\n    if (!last) return;\n",
         "    cluster_barrier();\n    PHMAX(6);\n    if (!last) return;\n"),
        ("    const long long off = K * T - Q;                     // leading zero pairs\n",
         "    const long long off = K * T - Q;\n"
         "    asm volatile(\"\" :: \"l\"(K));\n    PH(4);\n"),
        ("    // 3. each column's pairs by Horner",
         "    asm volatile(\"\" :: \"r\"(hi[0] ^ hi[1] ^ hi[2] ^ hi[3]));\n"
         "    PH(5);\n    // 3. each column's pairs by Horner"),
        ("        row[didx[d] >> 2] = w;\n    }\n}\n",
         "        row[didx[d] >> 2] = w;\n    }\n    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # other cluster sizes: one CTA a frame, at most 2 or 4 a frame, and
    # two CTAs an SM before halving
    ("a CTA a frame", [("constexpr int CLUSTER = 8;",
                        "constexpr int CLUSTER = 1;")]),
    ("at most 2 a frame", [("constexpr int CLUSTER = 8;",
                            "constexpr int CLUSTER = 2;")]),
    ("at most 4 a frame", [("constexpr int CLUSTER = 8;",
                            "constexpr int CLUSTER = 4;")]),
    ("2 CTAs an SM", [("constexpr int CTA_TARGET = 132;",
                       "constexpr int CTA_TARGET = 264;")]),
    # a pair's CRC by eight dependent steps of the byte table
    ("byte tables", [(K5_SLICING, K5_BYTE_STEPS)]),
    # wider CTAs: 512 threads (at most 2 a frame), or 1024 and one a frame
    ("512 threads", [("constexpr int LOG_THREADS = 8; ",
                      "constexpr int LOG_THREADS = 9; "),
                     ("constexpr int CLUSTER = 8;",
                      "constexpr int CLUSTER = 2;")]),
    # the pairs not loaded (a wrong result): what their latency costs
    ("no pair loads", [("        if (u < K && p >= 0) load_pair(row, p, vec, hi[u], lo[u]);",
                        "        if (u < K && p >= 0 && W < 0) load_pair(row, p, vec, hi[u], lo[u]);")]),
    # the tables' image not copied (a wrong result): what its loads cost
    ("no table image", [("        if (tid + c * THREADS < n4) img[c] = __ldg(",
                         "        if (tid + c * THREADS < n4 && W < 0) img[c] = __ldg(")]),
    ("1024 threads, a CTA a frame", [("constexpr int LOG_THREADS = 8; ",
                                      "constexpr int LOG_THREADS = 10; "),
                                     ("constexpr int CLUSTER = 8;",
                                      "constexpr int CLUSTER = 1;")]),
]
K6_SUM = ("        double s = 0.0;\n#pragma unroll\n"
          "        for (int j = 0; j < i; ++j)\n"
          "            s = __dadd_rn(s, __dmul_rn(lpc[j], ac[i - j]));\n")
# the guessed order's coefficients from their owner lane, and the one-thread
# design's second recursion up to the guess in their place
K6_PICK = (
    "    float cs[OT];\n"
    "    const int owner = (order - 1) % G, s_own = (order - 1) / G;\n"
    "#pragma unroll\n"
    "    for (int j = 0; j < OT; ++j) {\n"
    "        float v = own[0][j];\n"
    "#pragma unroll\n"
    "        for (int s = 1; s < NS; ++s) v = s == s_own ? own[s][j] : v;\n"
    "        cs[j] = __shfl_sync(FULL, v, owner, G);\n"
    "    }\n")
K6_RECOMPUTE = """\
    float cs[OT];
    double l2[OT];
#pragma unroll
    for (int j = 0; j < OT; ++j) l2[j] = 0.0;
    double e2 = ac[0];
    bool d2 = e2 == 0.0, d_at = d2;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
        if (i >= order) continue;
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < i; ++j)
            s = __dadd_rn(s, __dmul_rn(l2[j], ac[i - j]));
        const double safe = e2 == 0.0 ? 1.0 : e2;
        const double rr = __ddiv_rn(-__dadd_rn(ac[i + 1], s), safe);
#pragma unroll
        for (int j = 0; j < i / 2; ++j) {
            const double x = l2[j], y = l2[i - 1 - j];
            l2[j] = __dadd_rn(x, __dmul_rn(rr, y));
            l2[i - 1 - j] = __dadd_rn(y, __dmul_rn(rr, x));
        }
        if (i & 1) {
            const int mid = (i - 1) >> 1;
            l2[mid] = __dadd_rn(l2[mid], __dmul_rn(rr, l2[mid]));
        }
        l2[i] = rr;
        e2 = __dmul_rn(e2, __dsub_rn(1.0, __dmul_rn(rr, rr)));
        d_at = d2;
        d2 = d2 || e2 == 0.0;
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) cs[j] = d_at ? 0.0f : (float)(-l2[j]);
"""
# K6: clock64 at 1 the autocorrelations in shared memory, 2 the recursion
# done, 3 the guess (the shuffle argmin), 4 the quantizer's shift and
# scale, 5 its error feedback done, 7 the end (the last quantizer of the
# CTA's problem 0's lanes)
K6_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ double s_ac[PPC][OT + 1];\n",
         "    PHSTART();\n    __shared__ double s_ac[PPC][OT + 1];\n"),
        ("    __syncwarp();\n    const double* ac = s_ac[slot];\n",
         "    __syncwarp();\n    PH(1);\n    const double* ac = s_ac[slot];\n"),
        ("    const double bpsd = (double)bps;\n",
         "    PH(2);\n    const double bpsd = (double)bps;\n"),
        ("    double error = 0.0;\n", "    PH(4);\n    double error = 0.0;\n"),
        ("    int* row = a.qc + k * MAX_ORDER;\n",
         "    PH(5);\n    int* row = a.qc + k * MAX_ORDER;\n"),
        ("    const int order = (best >> 1) + 1;\n",
         "    PH(3);\n    const int order = (best >> 1) + 1;\n"),
        ("        quantize<OT>(a, prob * nP + p, cs, order, prec, ok && ok_p);\n"
         "    }\n}\n",
         "        quantize<OT>(a, prob * nP + p, cs, order, prec, ok && ok_p);\n"
         "    }\n    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # lanes a problem: half as many (each lane two orders), or a warp
    ("4-16 lanes a problem", [("return ot <= 8 ? 8 : ot <= 16 ? 16 : 32;",
                               "return ot <= 8 ? 4 : ot <= 16 ? 8 : 16;")]),
    ("a warp a problem", [("return ot <= 8 ? 8 : ot <= 16 ? 16 : 32;",
                           "return 32;")]),
    # the recursion's steps not unrolled: its state in local memory
    ("state in local memory", [
        ("#pragma unroll\n    for (int i = 0; i < OT; ++i) {\n        if (i >= O)",
         "#pragma unroll 1\n    for (int i = 0; i < OT; ++i) {\n        if (i >= O)")]),
    # the recursion again up to the guess, as the one-thread design did
    ("two recursions", [(K6_PICK, K6_RECOMPUTE)]),
    ("CTAs of 4 warps", [("constexpr int CTA = 32; ",
                          "constexpr int CTA = 128; ")]),
    # the coefficients through a triangle in shared memory, written in a
    # branch of their owner lane, in place of registers and shuffles
    ("triangle in shared memory", [
        ("    __shared__ double s_ac[PPC][OT + 1];\n",
         "    __shared__ double s_ac[PPC][OT + 1];\n"
         "    __shared__ float s_tri[PPC][OT * (OT + 1) / 2];\n"),
        ("            own[i / G][j] = mine ? c : own[i / G][j];\n        }\n",
         "            own[i / G][j] = mine ? c : own[i / G][j];\n        }\n"
         "        if (mine) {\n#pragma unroll\n"
         "            for (int j = 0; j <= i; ++j)\n"
         "                s_tri[slot][i * (i + 1) / 2 + j] = own[i / G][j];\n"
         "        }\n"),
        (K6_PICK,
         "    float cs[OT];\n"
         "    __syncwarp();\n#pragma unroll\n"
         "    for (int j = 0; j < OT; ++j)\n"
         "        cs[j] = j < order ? s_tri[slot][(order - 1) * order / 2 + j]\n"
         "                          : 0.0f;\n")]),
    # the recursion's divisions cut out (a wrong result: a multiply in
    # their place)
    ("no division", [("        const double rr = __ddiv_rn(-__dadd_rn(ac[i + 1], s), safe);",
                      "        const double rr = __dmul_rn(-__dadd_rn(ac[i + 1], s), safe);")]),
    # the inner sum's products on the lanes (lane j the j-th), gathered by
    # shuffles and summed in order by every lane
    ("lanes over j", [(K6_SUM,
                       "        double prod = 0.0;\n#pragma unroll\n"
                       "        for (int j = 0; j < i; ++j)\n"
                       "            if (gl == j % G) prod = __dmul_rn(lpc[j], ac[i - j]);\n"
                       "        double s = 0.0;\n#pragma unroll\n"
                       "        for (int j = 0; j < i; ++j)\n"
                       "            s = __dadd_rn(s, __shfl_sync(FULL, prod, j % G, G));\n")]),
]

# K10: clock64 at 1 the frame read and ORed (the warps' ORs met), 2 the
# wasted bits known, 7 the end (the last warp past its stores)
K10_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    const int N = a.N, S = a.share;\n",
         "    PHSTART();\n    const int N = a.N, S = a.share;\n"),
        ("        s_nz[warp] = nz;\n    }\n    __syncthreads();\n",
         "        s_nz[warp] = nz;\n    }\n    __syncthreads();\n"
         "    PH(1);\n"),
        ("    // this part of every candidate's shifted samples\n",
         "    PH(2);\n    // this part of every candidate's shifted samples\n"),
        ("    }\n}\n\ntemplate <typename In>\nint launch(",
         "    }\n    PHMAX(7);\n}\n\ntemplate <typename In>\nint launch("),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # one CTA a frame at every size, which writes every sample
    ("one CTA a frame", [("constexpr int SPLIT = 2;",
                          "constexpr int SPLIT = 1;")]),
    ("four CTAs a frame", [("constexpr int SPLIT = 2;",
                            "constexpr int SPLIT = 4;")]),
    ("two CTAs of 256 threads", [("constexpr int THREADS = 512;",
                                  "constexpr int THREADS = 256;")]),
    # two steps' loads in flight together
    ("unroll 2", [("        for (int n = 4 * t; n < N; n += 4 * THREADS) {",
                   "#pragma unroll 2\n"
                   "        for (int n = 4 * t; n < N; n += 4 * THREADS) {")]),
]

# K11: clock64 (thread 0) at 4 the stage's copies landed (several
# windows), 1 the windowed samples (and flags) in shared memory (the rows'
# loads used), 2 its fmas done, 3 its tree done, 7 the end (the last warp
# past the combine); with one window the CTA of a row, else the first
# (row, window) pair's warp
K11_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
         "    const int N = a.N, O = a.O, L1 = O + 1, W",
         "    PHSTART();\n"
         "    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
         "    const int N = a.N, O = a.O, L1 = O + 1, W"),
        ("            cp_async_wait_all();\n            __syncthreads();\n",
         "            cp_async_wait_all();\n            __syncthreads();\n"
         "            PH(4);\n"),
        ("            __syncthreads();\n            if (!active) continue;\n",
         "            __syncthreads();\n            PH(1);\n"
         "            if (!active) continue;\n"),
        ("        // the trees of every lag side by side",
         "        PH(2);\n        // the trees of every lag side by side"),
        ("        __syncthreads();\n        // the combine",
         "        PH(3);\n        __syncthreads();\n        // the combine"),
        ("            *dst = s;\n        }\n    }\n}\n",
         "            *dst = s;\n        }\n    }\n    PHMAX(7);\n}\n"),
        # one window
        ("    static_assert(ONE_THREADS == BLOCK,",
         "    PHSTART();\n    static_assert(ONE_THREADS == BLOCK,"),
        ("        const bool live = __syncthreads_or(nonzero);\n",
         "        const bool live = __syncthreads_or(nonzero);\n"
         "        PH(1);\n"),
        ("    // the tree: a warp's columns",
         "    PH(2);\n    // the tree: a warp's columns"),
        ("    __syncthreads();\n    if (t < L1) {\n",
         "    PH(3);\n    __syncthreads();\n    if (t < L1) {\n"),
        ("__dmul_rn(a.combine[ai], v));\n    }\n}\n",
         "__dmul_rn(a.combine[ai], v));\n    }\n    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    # every block walked (the same sums: a skipped block adds zeros)
    ("no skip", [("if (lane == 0) s_flag[q][b] = any != 0u;",
                  "if (lane == 0) s_flag[q][b] = 1;"),
                 ("        const int nblk = live\n",
                  "        const int nblk = true\n")]),
    # one window: a warp skips a block whose 32 first factors are all zero
    ("one window, a warp's skip", [
        ("            const float d0 = s_d[i];\n#pragma unroll",
         "            const float d0 = s_d[i];\n"
         "            if (!__any_sync(FULL, d0 != 0.f)) continue;\n"
         "#pragma unroll")]),
    # one window through the layout of several (a CTA of 384 threads two
    # rows, a warp a row computing)
    ("one window as several", [("    if (a.W == 1) {\n",
                                "    if (false) {\n")]),
    # several windows: a window's lags over warps, -8's in parts of 8
    # (8, 5)
    ("lag parts", [("return maxlag <= 12 ? maxlag + 1 : 12;",
                    "return maxlag <= 8 ? 4 : maxlag <= 12 ? 8 : 12;")]),
    ("a row a CTA", [("constexpr int MAX_ROWS = 2;",
                      "constexpr int MAX_ROWS = 1;")]),
    # the stage alone (a wrong result: no fmas, trees of zeros)
    ("stage only", [("            if (!active) continue;\n",
                     "            if (true) continue;\n"),
                    ("        for (int k = 0; k < nblk; ++k) {\n"
                     "            const int i = k * ONE_THREADS + t;",
                     "        for (int k = 0; k < 0 * nblk; ++k) {\n"
                     "            const int i = k * ONE_THREADS + t;")]),
]

# K8's "phases" (both designs): clock64 durations summed over the CTA's
# work in thread 0's view, by slot: 1 the stage (signal, and the
# coefficient table where the design has one), 2 the taps, 3 the
# residuals and their stores, 4 the flags, 5 the fixed orders; 7 the
# end (the last warp's clock64, PHMAX) and 9 the CTA's last globaltimer.
# A CTA's index is linear over a 2-D grid.
K8_PHASE_DEFS = PHASE_DEFS.replace(
    "blockIdx.x * 10", "(blockIdx.x + blockIdx.y * gridDim.x) * 10") + r"""
#define PHT(v) const long long v = clock64()
#define PHADD(k, v) do { if (threadIdx.x == 0) g_ph[(blockIdx.x + \
    blockIdx.y * gridDim.x) * 10 + (k)] += clock64() - (v); } while (0)
"""

# The earlier design (a CTA a (row, candidate group)), applied to an --other
# source that has it: its phases, its "f64" taps as 32 x 32 -> 64-bit
# multiply-adds (mad.wide.s32: the window and coefficient cast after the
# product, not before; exact for int32 signals only), and the taps or
# the stores alone (a wrong result, timed only)
K8_PARENT_VARIANTS = [
    ("phases", [
        ("namespace {\n", "namespace {\n" + K8_PHASE_DEFS),
        ("    const int t = threadIdx.x;\n    const int r = blockIdx.x;\n",
         "    PHSTART();\n"
         "    const int t = threadIdx.x;\n    const int r = blockIdx.x;\n"),
        ("        __syncthreads();                     // the last tile is "
         "read\n",
         "        PHT(ph_s);\n"
         "        __syncthreads();                     // the last tile is "
         "read\n"),
        ("            xs[i] = (n >= 0 && n < N) ? x[n] : X(0);\n        }\n"
         "        __syncthreads();\n",
         "            xs[i] = (n >= 0 && n < N) ? x[n] : X(0);\n        }\n"
         "        __syncthreads();\n        PHADD(1, ph_s);\n"),
        ("        if (g == 0) {\n            // fixed order o",
         "        PHT(ph_f);\n        if (g == 0) {\n            // fixed order o"),
        ("        } else {\n            using T = typename std::conditional"
         "<F64, long long,\n",
         "            PHADD(5, ph_f);\n"
         "        } else {\n            using T = typename std::conditional"
         "<F64, long long,\n"),
        ("                for (int j = 0; j < taps; ++j) {\n",
         "                PHT(ph_t);\n"
         "                for (int j = 0; j < taps; ++j) {\n"),
        ("p2 += q * w2; p3 += q * w3;\n                }\n",
         "p2 += q * w2; p3 += q * w3;\n                }\n"
         "                PHADD(2, ph_t);\n                PHT(ph_e);\n"),
        ("                store4(res_r + (size_t)(FIXED + c0 + c) * N, n0, "
         "N, vec,\n                       v[0], v[1], v[2], v[3]);\n",
         "                store4(res_r + (size_t)(FIXED + c0 + c) * N, n0, "
         "N, vec,\n                       v[0], v[1], v[2], v[3]);\n"
         "                PHADD(3, ph_e);\n"),
        ("    // the flags (a CTA reduction each) and the orders\n",
         "    PHT(ph_g);\n"),
        ("a.order_all[(size_t)r * C + FIXED + c0 + c] = s_order[c];\n"
         "            }\n        }\n    }\n}\n",
         "a.order_all[(size_t)r * C + FIXED + c0 + c] = s_order[c];\n"
         "            }\n        }\n    }\n    PHADD(4, ph_g);\n"
         "    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    ("mad.wide", [
        ("namespace {\n", "namespace {\n" + r"""
template <typename T>
__device__ __forceinline__ void mac(T& p, T q, T w) { p += q * w; }
__device__ __forceinline__ void mac(long long& p, long long q,
                                    long long w) {
    asm("mad.wide.s32 %0, %1, %2, %0;"
        : "+l"(p) : "r"((int)q), "r"((int)w));
}
"""),
        ("p0 += q * w0; p1 += q * w1; p2 += q * w2; p3 += q * w3;",
         "mac(p0, q, w0); mac(p1, q, w1); mac(p2, q, w2); "
         "mac(p3, q, w3);")]),
    ("taps only", [
        ("                store4(res_r + (size_t)(FIXED + c0 + c) * N, n0, "
         "N, vec,\n",
         "                if (a.R < 0) store4(res_r + (size_t)(FIXED + c0 "
         "+ c) * N, n0, N, vec,\n"),
        ("                store4(res_r + (size_t)o * N, n0, N, vec, v[0], "
         "v[1], v[2],\n",
         "                if (a.R < 0) store4(res_r + (size_t)o * N, n0, N, "
         "vec, v[0], v[1], v[2],\n")]),
    ("stores only", [("const int taps = min(order, a.max_j);",
                      "const int taps = 0 * min(order, a.max_j);")]),
]
# The design of csrc/candidate_residuals.cu (up to 8 CTAs a row, each a
# run of spans through a ring of cp.async buffers): its phases (slot 6
# the block's prologue: the ring's first copies issued and the
# coefficients staged; slot 1 the waits for a span and the barriers);
# the "f64" taps of int32 signals as 32 x 32 -> 64-bit multiply-adds
# (mad.wide.s32 into int64 sums) in place of float64 fma; chunks of 4
# and 8 "i32" candidates, of 3 and 5 float64 ones; ptxas told that 3
# CTAs an SM will do (its register budget 170, not its own choice of 128
# with a spill); CTAs of 64 and 256 threads (spans of 256 and 1024
# samples); a ring of 2; a CTA a span (8 CTAs a row whatever the rows);
# the taps or the stores alone (a wrong result, timed only)
K8_VARIANTS = [
    ("base", []),
    ("phases", [
        ("namespace {\n", "namespace {\n" + K8_PHASE_DEFS),
        ("    const int t = threadIdx.x;\n    const int part = blockIdx.x;\n",
         "    PHSTART();\n"
         "    const int t = threadIdx.x;\n    const int part = blockIdx.x;\n"),
        ("            __syncthreads();                 // the last block is "
         "read\n",
         "            PHT(ph_p);\n"
         "            __syncthreads();                 // the last block is "
         "read\n"),
        ("            for (int i = 0; i < nsp; ++i) {\n"
         "                // span i + RING - 1",
         "            PHADD(6, ph_p);\n"
         "            for (int i = 0; i < nsp; ++i) {\n"
         "                PHT(ph_s);\n"
         "                // span i + RING - 1"),
        ("                const X* xs = sm.xs[i % RING];\n",
         "                PHADD(1, ph_s);\n"
         "                const X* xs = sm.xs[i % RING];\n"),
        ("                    if (blk == 0)\n"
         "                        fixed_rows<X, WIDE>(xs, base, n0, N, vec, "
         "res_r,\n                                            bad);\n",
         "                    PHT(ph_f);\n"
         "                    if (blk == 0)\n"
         "                        fixed_rows<X, WIDE>(xs, base, n0, N, vec, "
         "res_r,\n                                            bad);\n"
         "                    PHADD(5, ph_f);\n"),
        ("                __syncthreads();             // span i's buffer is "
         "read\n",
         "                PHT(ph_b);\n"
         "                __syncthreads();             // span i's buffer is "
         "read\n                PHADD(1, ph_b);\n"),
        ("    for (int g = 0; 4 * g < taps; ++g) {\n",
         "    PHT(ph_t);\n    for (int g = 0; 4 * g < taps; ++g) {\n"),
        ("        for (int k = 0; k < 4; ++k) hi[k] = w[k];\n    }\n",
         "        for (int k = 0; k < 4; ++k) hi[k] = w[k];\n    }\n"
         "    PHADD(2, ph_t);\n    PHT(ph_e);\n"),
        ("        store4(rows + (size_t)c * N, n0, N, vec, v);\n    }\n}\n",
         "        store4(rows + (size_t)c * N, n0, N, vec, v);\n    }\n"
         "    PHADD(3, ph_e);\n}\n"),
        ("            // the flags and the orders of the block\n",
         "            PHT(ph_g);\n"),
        ("                    a.order_all[(size_t)r * C + FIXED + cb + t] =\n"
         "                        sm.order[t];\n                }\n"
         "            }\n        }\n    }\n}\n",
         "                    a.order_all[(size_t)r * C + FIXED + cb + t] =\n"
         "                        sm.order[t];\n                }\n"
         "            }\n            PHADD(4, ph_g);\n        }\n    }\n"
         "    PHMAX(7);\n}\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
    ("mad.wide", [
        ("template <> struct Taps<int, true> {\n"
         "    using W = double; using Q = double; using A = double;\n"
         "    static constexpr int CHUNK = 4;\n};\n",
         "template <> struct Taps<int, true> {\n"
         "    using W = int; using Q = int; using A = long long;\n"
         "    static constexpr int CHUNK = 5;\n};\n"
         "__device__ __forceinline__ void mac(long long& p, int q, int w) "
         "{\n    asm(\"mad.wide.s32 %0, %1, %2, %0;\" : \"+l\"(p) : "
         "\"r\"(q), \"r\"(w));\n}\n")]),
    # the float64 sums to int64 by adding 1.5 x 2^52 (exact for an
    # integer-valued |sum| <= 2^51: lpc_residual's bound on int32 signals
    # gives < 2^50) in place of F2I.S64 (a 64-bit conversion)
    ("1.5 x 2^52", [
        ("// ---- PTX helpers ----\n",
         "__device__ __forceinline__ long long as_int64(long long v) "
         "{ return v; }\n"
         "__device__ __forceinline__ long long as_int64(double v) {\n"
         "    return __double_as_longlong(v + 6755399441055744.0)\n"
         "        - 0x4338000000000000LL;\n}\n\n"
         "// ---- PTX helpers ----\n"),
        ("                    - ((long long)acc[c][k] >> sh);",
         "                    - (as_int64(acc[c][k]) >> sh);")]),
    ("i32 chunks of 4", [("static constexpr int CHUNK = 5;",
                          "static constexpr int CHUNK = 4;")]),
    ("i32 chunks of 8", [("static constexpr int CHUNK = 5;",
                          "static constexpr int CHUNK = 8;")]),
    ("f64 chunks of 3", [("using A = double;\n    static constexpr int "
                          "CHUNK = 4;", "using A = double;\n    static "
                          "constexpr int CHUNK = 3;")]),
    ("f64 chunks of 5", [("using A = double;\n    static constexpr int "
                          "CHUNK = 4;", "using A = double;\n    static "
                          "constexpr int CHUNK = 5;")]),
    ("3 CTAs an SM", [("__launch_bounds__(THREADS)\ncandidate_residuals_kernel",
                       "__launch_bounds__(THREADS, 3)\n"
                       "candidate_residuals_kernel")]),
    ("f64 chunks of 5, 3 CTAs an SM", [
        ("using A = double;\n    static constexpr int CHUNK = 4;",
         "using A = double;\n    static constexpr int CHUNK = 5;"),
        ("__launch_bounds__(THREADS)\ncandidate_residuals_kernel",
         "__launch_bounds__(THREADS, 3)\ncandidate_residuals_kernel")]),
    ("CTAs of 64 threads", [("constexpr int THREADS = 128;",
                             "constexpr int THREADS = 64;")]),
    ("CTAs of 256 threads", [("constexpr int THREADS = 128;",
                              "constexpr int THREADS = 256;")]),
    ("ring of 2", [("constexpr int RING = 4;", "constexpr int RING = 2;")]),
    ("a CTA a span", [("    while (p > 1 && (long long)R * p > slots) "
                       "p = (p + 1) / 2;\n", "")]),
    ("taps only", [
        ("        store4(rows + (size_t)c * N, n0, N, vec, v);\n",
         "        if (N < 0) store4(rows + (size_t)c * N, n0, N, vec, v);\n"),
        ("        store4(res_r + (size_t)o * N, n0, N, vec, v);\n",
         "        if (N < 0) store4(res_r + (size_t)o * N, n0, N, vec, v);\n")]),
    ("stores only", [("    for (int g = 0; 4 * g < taps; ++g) {\n",
                      "    for (int g = 0; 4 * g < 0 * taps; ++g) {\n")]),
]

# One thread's chain of dependent samples, as the recursion runs it: the
# generic form (x = (int)(P >> sh) + r; P = q * x + c by mad.wide) and the
# folded one (x = the low word of P >> sh by one funnel shift; P = q * x + c
# by the kernel's carry chain of two 32-bit multiply-adds, the residual in
# c off the chain).  Prints cycles a sample and the SM clock.
CHAIN_PROBE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
    long long d;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
    return d;
}
__device__ __forceinline__ long long mad_cc(int a, int b, long long c) {
    unsigned lo, hi;
    asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\t"
        "madc.hi.s32 %1, %2, %3, %5;"
        : "=r"(lo), "=r"(hi)
        : "r"(a), "r"(b), "r"((unsigned)c),
          "r"((unsigned)((unsigned long long)c >> 32)));
    return (long long)(((unsigned long long)hi << 32) | lo);
}
__device__ __forceinline__ long long gtimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__global__ void chain_probe(long long* out, int n, int q, int sh,
                            long long c) {
    long long P = c;
    const long long g0 = gtimer(), t0 = clock64();
    for (int i = 0; i < n; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int x = (int)(P >> sh) + (i + u);
            P = mad_wide(q, x, c);
        }
    }
    const long long t1 = clock64();
    long long F = c;
    for (int i = 0; i < n; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int x = (int)__funnelshift_r(
                (unsigned)F, (unsigned)((unsigned long long)F >> 32), sh);
            F = mad_cc(q, x, c + ((long long)(i + u) << sh));
        }
    }
    const long long t2 = clock64(), g1 = gtimer();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0; out[1] = t2 - t1; out[2] = g1 - g0;
    }
    out[3 + threadIdx.x] = P + F;
}
// `lanes` threads (1 or 32) of one warp run the chains side by side
extern "C" int flac_chain_probe(long long* out, int n, int q, int sh,
                                int lanes, void* stream) {
    chain_probe<<<1, lanes, 0, (cudaStream_t)stream>>>(out, n, q, sh, 12345);
    return (int)cudaGetLastError();
}
// the least a launch takes: `ctas` CTAs of `threads` threads that do
// nothing, in clusters of `cluster` CTAs, each holding `smem` bytes of
// shared memory (launched as the cluster kernels are, by cudaLaunchKernelEx)
__global__ void empty_kernel(int) {}
extern "C" int flac_empty_launch(int ctas, int threads, int cluster, int smem,
                                 void* stream) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel, 0);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
"""


def build(kernel: str, variants, others, other_variants=()) -> dict:
    """One nvcc per variant, all started together: {name: (library,
    ptxas lines)}.  `others`: {label: directory} of other versions of the
    source (another commit's csrc/), built unchanged, and with each of
    `other_variants` ("label name") where all of its edits apply."""
    from flac_tpu_torch import kernels
    OUT.mkdir(parents=True, exist_ok=True)
    text = (SRC / f"{kernel}.cu").read_text()
    variants = list(variants)
    for label, d in others.items():
        path = Path(d) / f"{kernel}.cu"
        if not path.exists():
            continue
        variants.append((label, (path, [])))
        other = path.read_text()
        variants += [(f"{label} {name}", (path, edits))
                     for name, edits in other_variants
                     if all(old in other for old, _ in edits)]
    jobs = {}
    for i, (name, edits) in enumerate(variants):
        if isinstance(edits, tuple):
            path, edits = edits
            text_i = path.read_text()
        else:
            text_i = text
        src = text_i
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{kernel} variant {name!r}: {old!r} is "
                                 "not in the source")
            src = src.replace(old, new)
        path = OUT / f"{kernel}_v{i}.cu"
        path.write_text(src)
        jobs[name] = (path.with_suffix(".so"), subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(SRC), "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    outs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    for name, (lib, proc) in jobs.items():
        out = outs[name]
        if proc.returncode != 0:
            if name == "base":
                raise SystemExit(f"nvcc failed for {kernel}:\n{out}")
            print(json.dumps({"kernel": kernel, "variant": name,
                              "nvcc_failed": out[-2000:]}), flush=True)
            continue
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        libs[name] = (ctypes.CDLL(str(lib)), regs)
    return libs


def device_ms(fn, kernel: str, runs: int = 50) -> float:
    """Device ms of one launch: torch.profiler over `runs` launches; a
    trace that misses launches (CUPTI drops a window's records now and
    then) is taken again, twice, and then chip_smoke.queued_device_ms's
    CUDA events around calls queued behind a sleep take its place."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    from chip_smoke import _device_us, queued_device_ms
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel in e.key]
        n = sum(e.count for e in ev)
        if n == runs:
            return sum(_device_us(e, True) for e in ev) / n / 1e3
    return queued_device_ms(fn, runs)


def poison(outputs) -> None:
    """Fill a launch's outputs with values no kernel writes (-1, NaN), so
    that a check after one launch sees only that launch's writes."""
    for t in outputs if isinstance(outputs, (tuple, list)) else (outputs,):
        if t is not None:
            t.fill_(float("nan") if t.is_floating_point() else -1)


def in_pairs(run_base, run_other, kernel: str, n: int) -> dict:
    """`n` pairs of device_ms of "base" and of another version, which of
    the two runs first alternating: each side's times, quartiles (25, 50,
    75%) and the pairs it won (a tie counts for neither)."""
    import numpy as np
    base, other = [], []
    for k in range(n):
        if k % 2 == 0:
            base.append(device_ms(run_base, kernel))
            other.append(device_ms(run_other, kernel))
        else:
            other.append(device_ms(run_other, kernel))
            base.append(device_ms(run_base, kernel))
    return {"pairs": n, "base_pair_ms": base, "other_pair_ms": other,
            "base_quartiles_ms": [float(q) for q in np.percentile(
                base, [25, 50, 75])],
            "other_quartiles_ms": [float(q) for q in np.percentile(
                other, [25, 50, 75])],
            "base_wins": sum(b < o for b, o in zip(base, other)),
            "other_wins": sum(o < b for b, o in zip(base, other))}


def phases(lib, run, ctas: int, durations: bool = False) -> dict:
    """One launch of a "phases" variant: where each CTA's cycles go.  For
    each point k, the median and the largest count of cycles from the
    CTA's start (with `durations`, points 1-6 are cycles summed in their
    slots, over the CTAs that have them); `cta_ns`, the median and largest
    lifetime of a CTA; `start_spread_ns`, from the first CTA's start to
    the last's; `span_ns`, from the first start to the last end;
    `cycles_per_ns`, the SM clock."""
    import numpy as np
    import torch
    n = ctas * PHASE_SLOTS
    lib.flac_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flac_phases_clear.argtypes = [ctypes.c_int]
    torch.cuda.synchronize()
    if lib.flac_phases_clear(n):
        raise SystemExit("flac_phases_clear failed")
    run()
    torch.cuda.synchronize()
    buf = np.zeros(n, np.int64)
    if lib.flac_phases(buf.ctypes.data, n):
        raise SystemExit("flac_phases failed")
    ph = buf.reshape(ctas, PHASE_SLOTS)
    out = {"ctas": int((ph[:, 8] != 0).sum())}
    for k in range(1, 8):
        d = ph[:, k] if durations and k < 7 else ph[:, k] - ph[:, 0]
        d = d[ph[:, k] != 0]
        if len(d):
            out[f"point{k}_cycles"] = [int(np.median(d)), int(d.max())]
    ph = ph[ph[:, 8] != 0]          # the CTAs that ran (of at most ctas)
    life = ph[:, 9] - ph[:, 8]
    last = max(k for k in range(1, 8) if (ph[:, k] != 0).any())
    out["cta_ns"] = [int(np.median(life)), int(life.max())]
    out["start_spread_ns"] = int(ph[:, 8].max() - ph[:, 8].min())
    out["span_ns"] = int(ph[:, 9].max() - ph[:, 8].min())
    ok = life > 0
    out["cycles_per_ns"] = float(np.median(
        (ph[ok, last] - ph[ok, 0]) / life[ok])) if ok.any() else None
    return out


def k1_inputs():
    """The fields of one -5 batch of the 180 s track's first 64 frames."""
    import numpy as np
    import torch

    from chip_smoke import RATE, TRACK_SECONDS
    from flac_tpu_torch import EncoderConfig, signals
    from flac_tpu_torch.encoder import encode_batch
    from flac_tpu_torch.models import frame as frame_mod
    captured = {}
    real_pack = frame_mod.pack_cuda.pack_fields64

    def capture(nz, pay, pb, W):
        captured["args"] = (nz.clone(), pay.clone(), pb.clone(), W)
        return real_pack(nz, pay, pb, W)
    frame_mod.pack_cuda.pack_fields64 = capture
    try:
        pcm = signals.make_test_signal(TRACK_SECONDS * RATE,
                                       seed=180)[:, :64 * 4096]
        blocks = torch.from_numpy(np.ascontiguousarray(
            pcm.reshape(2, 64, 4096).transpose(1, 0, 2))).cuda()
        cfg = EncoderConfig.from_preset(5, blocksize=4096).resolve()
        encode_batch(blocks, 0, cfg, 4096)
    finally:
        frame_mod.pack_cuda.pack_fields64 = real_pack
    return captured["args"]


def k2_inputs():
    """The first full decode batch of a 100 s -5 stream."""
    import torch

    from chip_smoke import RATE, decode_batch_inputs, encode
    from flac_tpu_torch import signals
    stream, _ = encode(signals.make_test_signal(100 * RATE, seed=180), 5)
    [(arrays, kw)] = decode_batch_inputs(stream, first_only=True)
    return [torch.from_numpy(a).cuda() for a in arrays], kw


def k3_inputs():
    """K3's arguments on the first full decode batch of a 100 s -5 stream,
    as each engine hands them over: {"int32": the device engine's (the
    codes of K2 as the [S, N] residual matrix), "int16": the fast engine's
    (the native full parse's residuals)}, each (res, [order, shift, qlp,
    wasted, assignment], max_order); int16 PCM out."""
    import numpy as np
    import torch

    from chip_smoke import RATE, encode, restore_batch_inputs
    from flac_tpu_torch import decoder_device as dd
    from flac_tpu_torch import native, signals
    from flac_tpu_torch.decoder import scan_frames
    from flac_tpu_torch.ops import bitunpack
    from flac_tpu_torch.ref_decoder import parse_metadata
    stream, _ = encode(signals.make_test_signal(100 * RATE, seed=180), 5)
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    arr = np.frombuffer(stream, np.uint8)
    prep = dd._prep_batch(arr, frames, list(range(1024)), 4096, 2)
    assert (prep[0].status == native.FT_OK).all()
    arrays, kw = dd.batch_inputs(arr, *prep)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    res_tl, _ = bitunpack.rice_codes_plain(*t[:3], T=128, NROW=kw["NROW"],
                                           SEG=kw["SEG"], wide=False)
    S = t[3].shape[0]
    res = res_tl.t().reshape(S, -1)[:, :4096].contiguous()
    [(farrays, fkw)] = restore_batch_inputs(stream, first_only=True)
    ft = [torch.from_numpy(farrays[k]).cuda() for k in
          ("order", "shift", "qlp", "wasted", "assignment")]
    assert farrays["res"].dtype == np.int16
    return {"int32": (res, t[3:], kw["max_order"]),
            "int16": (torch.from_numpy(farrays["res"]).cuda(), ft,
                      fkw["max_order"])}


def k4_inputs() -> dict:
    """K4's launch arguments on the track's first 64 frames at -5 and on
    its first 256 (the ops form's choice): {label: (ins, outs, ints,
    layout)}, as assemble_cuda.launch_arguments gives them."""
    import numpy as np
    import torch

    from chip_smoke import RATE, TRACK_SECONDS, capture_ops
    from flac_tpu_torch import EncoderConfig, signals
    from flac_tpu_torch.models import frame as frame_mod
    from flac_tpu_torch.ops import assemble_cuda
    cfg = EncoderConfig.from_preset(5, blocksize=4096).resolve()
    pcm = signals.make_test_signal(TRACK_SECONDS * RATE, seed=180)
    out = {}
    for B in (64, 256):
        blocks = torch.from_numpy(np.ascontiguousarray(
            pcm[:, :B * 4096].reshape(2, B, 4096).transpose(1, 0, 2))).cuda()
        choice, signal, asg, nums, cfg_a, N, layout = capture_ops(
            blocks, cfg)["k4"]
        quad, wide = frame_mod.resolve_layout(
            cfg_a, signal.shape[2], choice.params.shape[-1], layout)
        ins, outs, ints, lay = assemble_cuda.launch_arguments(
            choice, signal, asg, nums, cfg_a, N, quad, wide)
        out[f"-5, B={B}"] = (ins, outs, ints, lay.group_layout)
    return out


def search_inputs() -> dict:
    """The arguments of K6 and K7 on the search inputs of the track's first
    64 frames at -5 and at -8 (the ops form's): {label: {"k6": (autoc,
    bps_eff, N, cfg), "k7": (res, order, N, max_po, cfg)}}."""
    from chip_smoke import RATE, TRACK_SECONDS, real_search
    from flac_tpu_torch import EncoderConfig, signals
    pcm = signals.make_test_signal(TRACK_SECONDS * RATE, seed=180)
    return {f"-{lv}": real_search(EncoderConfig.from_preset(
        lv, blocksize=4096).resolve(), pcm) for lv in (5, 8)}


def k5_inputs() -> dict:
    """K5's arguments (the words before the seal, byte_len, hdr_bytes) on
    the track's first 64 frames at -5 and on its first 256 (the ops
    form's): {label: (words, byte_len, hdr_bytes)}."""
    import numpy as np
    import torch

    from chip_smoke import RATE, TRACK_SECONDS, capture_ops
    from flac_tpu_torch import EncoderConfig, signals
    cfg = EncoderConfig.from_preset(5, blocksize=4096).resolve()
    pcm = signals.make_test_signal(TRACK_SECONDS * RATE, seed=180)
    out = {}
    for B in (64, 256):
        blocks = torch.from_numpy(np.ascontiguousarray(
            pcm[:, :B * 4096].reshape(2, B, 4096).transpose(1, 0, 2))).cuda()
        out[f"-5, B={B}"] = capture_ops(blocks, cfg)["k5"]
    return out


def time_k5(libs: dict, inputs: dict) -> None:
    """Time each built K5 library on each of `k5_inputs`, in turns with
    "base", each launch on a fresh copy of the words (the copy is not in
    the kernel's device time); each output compared with base's."""
    import torch

    from flac_tpu_torch.ops import seal_cuda
    stream = torch.cuda.current_stream().cuda_stream
    tab = seal_cuda.tables("cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, regs) in libs.items():
        lib.flac_frame_crc.argtypes = [p] * 4 + [i] * 2 + [p]
        for label, (words, byte_len, hdr) in inputs.items():
            B, W = words.shape
            mine, want = torch.empty_like(words), torch.empty_like(words)

            def call(lib_, w, words=words, byte_len=byte_len, hdr=hdr, B=B,
                     W=W):
                w.copy_(words)
                code = lib_.flac_frame_crc(w.data_ptr(), byte_len.data_ptr(),
                                           hdr.data_ptr(), tab.data_ptr(), B,
                                           W, stream)
                if code:
                    raise SystemExit(f"K5 {name!r}: CUDA error {code}")
            run = lambda lib=lib, mine=mine: call(lib, mine)  # noqa: E731
            ms = device_ms(run, "frame_crc_kernel")
            base = device_ms(lambda want=want: call(libs["base"][0], want),
                             "frame_crc_kernel")
            torch.cuda.synchronize()
            same = torch.equal(mine, want)
            extra = (phases(lib, run, B * seal_cuda.cluster_size(B))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K5", "variant": name,
                              "input": label, "B": B, "W": W, "ms": ms,
                              "base_ms": base, "same_as_base": same, **extra,
                              "ptxas": regs}), flush=True)


def time_k6(libs: dict, inputs: dict) -> None:
    """Time each built K6 library on the K6 arguments of `search_inputs`,
    in turns with "base"; each output compared with base's."""
    import torch

    from flac_tpu_torch.ops import lpc_cuda
    print(json.dumps({"kernel": "K6", "probe": "op cycles",
                      **lpc_cuda.op_cycles()}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, regs) in libs.items():
        lib.flac_lpc_coeffs.argtypes = [p] * 7 + [i] * 7 + [p]
        for label, seen in inputs.items():
            autoc, bps, N, cfg = seen["k6"]
            autoc, bps = autoc.contiguous(), bps.contiguous()
            B, CH, A, O1 = autoc.shape
            AC = lpc_cuda.candidates(A, O1 - 1, cfg)

            def outputs(B=B, CH=CH, AC=AC):
                return (torch.empty((B, CH, AC, 32), dtype=torch.int32,
                                    device="cuda"),
                        *(torch.empty((B, CH, AC), dtype=torch.int32,
                                      device="cuda") for _ in range(3)),
                        torch.empty((B, CH, AC), dtype=torch.bool,
                                    device="cuda"))
            mine, want = outputs(), outputs()

            def call(lib_, o, autoc=autoc, bps=bps, N=N, cfg=cfg):
                code = lib_.flac_lpc_coeffs(
                    autoc.data_ptr(), bps.data_ptr(),
                    *(t.data_ptr() for t in o), autoc.shape[0] * autoc.shape[1],
                    autoc.shape[2], autoc.shape[3] - 1, N,
                    int(cfg.do_exhaustive_model_search),
                    int(cfg.do_qlp_coeff_prec_search),
                    cfg.qlp_coeff_precision, stream)
                if code:
                    raise SystemExit(f"K6 {name!r}: CUDA error {code}")
            run = lambda lib=lib, mine=mine: call(lib, mine)  # noqa: E731
            ms = device_ms(run, "lpc_coeffs_kernel")
            base = device_ms(lambda want=want: call(libs["base"][0], want),
                             "lpc_coeffs_kernel")
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(mine, want))
            problems = B * CH * A
            extra = (phases(lib, run, lpc_cuda.ctas(problems, O1 - 1))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K6", "variant": name,
                              "input": label, "problems": problems,
                              "order": O1 - 1, "ms": ms, "base_ms": base,
                              "same_as_base": same, **extra,
                              "ptxas": regs}), flush=True)


def time_k4(libs: dict, inputs: dict) -> None:
    """Time each built K4 library on each of `k4_inputs`, in turns with
    "base"; each output compared with base's."""
    import torch

    from flac_tpu_torch.ops import assemble_cuda
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in libs.items():
        lib.flac_assemble_fields.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        for label, (ins, outs, ints, layout) in inputs.items():
            mine = [torch.empty_like(o) for o in outs]

            def run(lib=lib, ins=ins, mine=mine, ints=ints, layout=layout):
                ptrs = (ctypes.c_void_p * (len(ins) + len(mine)))(
                    *[t.data_ptr() for t in ins + mine])
                arr = (ctypes.c_longlong * len(ints))(*ints)
                code = lib.flac_assemble_fields(ptrs, len(ptrs), arr,
                                                len(arr), layout, stream)
                if code:
                    raise SystemExit(f"K4 {name!r}: CUDA error {code}")

            def run_base(ins=ins, outs=outs, ints=ints, layout=layout):
                ptrs = (ctypes.c_void_p * (len(ins) + len(outs)))(
                    *[t.data_ptr() for t in ins + outs])
                arr = (ctypes.c_longlong * len(ints))(*ints)
                libs["base"][0].flac_assemble_fields(
                    ptrs, len(ptrs), arr, len(arr), layout, stream)
            ms = device_ms(run, "assemble_fields_kernel")
            base = device_ms(run_base, "assemble_fields_kernel")
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(mine, outs))
            B = ints[0]
            extra = (phases(lib, run, B * assemble_cuda.cluster_size(B))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K4", "variant": name,
                              "input": label, "ms": ms, "base_ms": base,
                              "same_as_base": same, **extra,
                              "ptxas": regs}), flush=True)


def time_k7(libs: dict, inputs: dict) -> None:
    """Time each built K7 library on each input's K7 arguments
    (`search_inputs`), in turns with "base"; each output compared with
    base's."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, regs) in libs.items():
        lib.flac_rice_cost.argtypes = [p] * 6 + [i] * 6 + [p]
        for label, (res, order, N, max_po, cfg) in inputs.items():
            lead = tuple(res.shape[:-1])
            L, P = max_po + 1, 1 << max_po
            rows = res.numel() // N
            rice2_mode = cfg.rice_param_limit > 15

            def outputs():
                return (torch.empty(lead + (L,), dtype=torch.int32,
                                    device="cuda"),
                        torch.empty(lead + (L, P), dtype=torch.int32,
                                    device="cuda"),
                        torch.empty(lead + (L, P), dtype=torch.int32,
                                    device="cuda"),
                        torch.empty(lead + (L,), dtype=torch.bool,
                                    device="cuda"))
            mine, want = outputs(), outputs()

            def call(lib_, o, res=res, order=order, N=N, max_po=max_po,
                     cfg=cfg, rows=rows, rice2_mode=rice2_mode):
                code = lib_.flac_rice_cost(
                    res.data_ptr(), order.data_ptr(), o[0].data_ptr(),
                    o[1].data_ptr(), o[2].data_ptr(), o[3].data_ptr(),
                    rows, N, max_po, cfg.min_residual_partition_order,
                    int(rice2_mode), int(cfg.do_escape_coding), stream)
                if code:
                    raise SystemExit(f"K7 {name!r}: CUDA error {code}")
            run = lambda lib=lib, mine=mine: call(lib, mine)  # noqa: E731
            ms = device_ms(run, "rice_cost_kernel")
            base = device_ms(lambda want=want: call(libs["base"][0], want),
                             "rice_cost_kernel")
            torch.cuda.synchronize()
            same = all(torch.equal(mine[k], want[k]) for k in (0, 1, 3))
            extra = (phases(lib, run, rows) if name == "phases" else {})
            print(json.dumps({"kernel": "K7", "variant": name,
                              "input": label, "rows": rows, "N": N,
                              "partitions": P, "ms": ms, "base_ms": base,
                              "same_as_base": same, **extra,
                              "ptxas": regs}), flush=True)


def front_inputs() -> dict:
    """The arguments of K10 and K11 on the track's first 64 frames at -5
    and at -8 in the ops form (chip_smoke.py phase 6's inputs; K10 on the
    int16 upload): {label: {"k10": (pcm, cfg), "k11": (x, windows,
    combine, O)}}."""
    import torch
    out = {}
    for label, seen in search_inputs().items():
        pcm, cfg = seen["k10"]
        out[label] = {"k10": (pcm.to(torch.int16).contiguous(), cfg),
                      "k11": tuple(a.contiguous() if isinstance(
                          a, torch.Tensor) else a for a in seen["k11"])}
    # the sharded form's 256-frame batch (its upload int32): the -5
    # batch four times over
    pcm, cfg = out["-5"]["k10"]
    x, w, c, O = out["-5"]["k11"]
    out["-5, 256 frames"] = {
        "k10": (pcm.repeat(4, 1, 1).to(torch.int32).contiguous(), cfg),
        "k11": (x.repeat(4, 1, 1).contiguous(), w, c, O)}
    return out


def time_k10(libs: dict, inputs: dict, others=(), pairs: int = 0) -> None:
    """Time each built K10 library on each input's K10 arguments, in turns
    with "base"; each output held against the plain version.  `others`
    (the labels of --other) are also timed in `pairs` pairs with base.
    Every library writes the same output buffers, so that no time depends
    on where a buffer lies."""
    import torch

    from chip_smoke import stage_calls
    from flac_tpu_torch.ops import candidates_cuda
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    _, plain = stage_calls("k10")
    for label, seen in inputs.items():
        pcm, cfg = seen["k10"]
        want = plain(pcm, cfg)
        outs, args = candidates_cuda.launch_arguments(pcm, cfg)
        for name, (lib, regs) in libs.items():
            lib.flac_channel_candidates.argtypes = [p] * 5 + [i] * 7 + [p]

            def call(lib_):
                code = lib_.flac_channel_candidates(*args, stream)
                if code:
                    raise SystemExit(f"K10 {name!r}: CUDA error {code}")
            run = lambda lib=lib: call(lib)  # noqa: E731
            poison(outs)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, want))
            ms = device_ms(run, "channel_candidates_kernel")
            base = device_ms(lambda: call(libs["base"][0]),
                             "channel_candidates_kernel")
            extra = (phases(lib, run, candidates_cuda.ctas(
                pcm.shape[0], pcm.shape[1], cfg,
                torch.cuda.get_device_properties(0).multi_processor_count))
                if name == "phases" else {})
            if name in others and pairs:
                extra.update(in_pairs(lambda: call(libs["base"][0]), run,
                                      "channel_candidates_kernel", pairs))
            print(json.dumps({"kernel": "K10", "variant": name,
                              "input": label, "B": pcm.shape[0],
                              "N": pcm.shape[2], "dtype": str(pcm.dtype),
                              "ms": ms, "base_ms": base,
                              "same_as_plain": same, **extra,
                              "ptxas": regs}), flush=True)


def time_k11(libs: dict, inputs: dict, others=(), pairs: int = 0) -> None:
    """Time each built K11 library on each input's K11 arguments, in turns
    with "base"; each output held against the plain version.  `others`
    (the labels of --other) are also timed in `pairs` pairs with base.
    Every library writes the same output buffer."""
    import torch

    from flac_tpu_torch.ops import autoc_cuda, lpc
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, seen in inputs.items():
        x, w, c, O = seen["k11"]
        want = lpc.autocorrelation_plain(x, w, c, O)
        out, args = autoc_cuda.launch_arguments(x, w, c, O)
        plan = autoc_cuda.plan(x.shape[0] * x.shape[1], w.shape[0], O)
        for name, (lib, regs) in libs.items():
            lib.flac_window_autoc.argtypes = [p] * 4 + [i] * 6 + [p]

            def call(lib_):
                code = lib_.flac_window_autoc(*args, stream)
                if code:
                    raise SystemExit(f"K11 {name!r}: CUDA error {code}")
            run = lambda lib=lib: call(lib)  # noqa: E731
            poison(out)
            run()
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            ms = device_ms(run, "window_autoc_kernel")
            base = device_ms(lambda: call(libs["base"][0]),
                             "window_autoc_kernel")
            extra = (phases(lib, run, plan["ctas"])
                     if name == "phases" else {})
            if name in others and pairs:
                extra.update(in_pairs(lambda: call(libs["base"][0]), run,
                                      "window_autoc_kernel", pairs))
            print(json.dumps({"kernel": "K11", "variant": name,
                              "input": label, "rows": x.shape[0] * x.shape[1],
                              "windows": w.shape[0], "lags": O + 1,
                              "ms": ms, "base_ms": base,
                              "same_as_plain": same, **extra,
                              "ptxas": regs}), flush=True)


def k8_inputs() -> dict:
    """K8's arguments on the first 64 frames (ops form, int32) of the
    track at -5 and -8, of chip_smoke.py's 24-bit 96 kHz stereo at -8
    ("f64" mode) and of its 24-bit 5.1 at -5: {label: (x, qc, qshift,
    cand_order, bps_eff, fixed_wide, lpc_mode, max_order)}."""
    from chip_smoke import HIRES, RATE, TRACK_SECONDS, hires_cfg, \
        hires_pcm, real_search
    from flac_tpu_torch import EncoderConfig, signals
    pcm = signals.make_test_signal(TRACK_SECONDS * RATE, seed=180)
    out = {f"-{lv}": real_search(EncoderConfig.from_preset(
        lv, blocksize=4096).resolve(), pcm)["k8"] for lv in (5, 8)}
    for h, lv in ((HIRES[0], 8), (HIRES[1], 5)):
        out[f"{h.label} -{lv}"] = real_search(
            hires_cfg(h, lv), hires_pcm(h, 64 * 4096))["k8"]
    return out


def time_k8(libs: dict, inputs: dict, others=(), pairs: int = 0) -> None:
    """Time each built K8 library on each of `k8_inputs`, in turns with
    "base"; each output held against the plain version first
    (residuals_cuda.same_outputs: the rows comparable_rows takes, every
    flag and order).  `others` (the labels of --other) are also timed in
    `pairs` pairs with base.  Every library writes the same outputs."""
    import torch

    from flac_tpu_torch.models import subframe
    from flac_tpu_torch.ops import residuals_cuda
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, a in inputs.items():
        want = subframe.candidate_residuals_plain(*a)
        outs, args = residuals_cuda.launch_arguments(*a)
        rows, N = args[9], args[11]
        for name, (lib, regs) in libs.items():
            lib.flac_candidate_residuals.argtypes = [p] * 9 + [i] * 7 + [p]

            def call(lib_):
                code = lib_.flac_candidate_residuals(*args, stream)
                if code:
                    raise SystemExit(f"K8 {name!r}: CUDA error {code}")
            run = lambda lib=lib: call(lib)  # noqa: E731
            poison(outs)
            run()
            torch.cuda.synchronize()
            same = residuals_cuda.same_outputs(outs, want, a[5], a[6])
            ms = device_ms(run, "candidate_residuals_kernel")
            base = device_ms(lambda: call(libs["base"][0]),
                             "candidate_residuals_kernel")
            extra = {}
            if name.endswith("phases"):
                # room for the larger grid of the two designs: a CTA a
                # (row, span), or a (row, group of 4 candidates)
                extra = phases(lib, run, rows * max(
                    -(-N // residuals_cuda.SPAN), 1 + -(-a[1].shape[2] // 4)),
                    durations=True)
            if name in others and pairs:
                extra.update(in_pairs(lambda: call(libs["base"][0]), run,
                                      "candidate_residuals_kernel", pairs))
            if name == "base":
                # a yardstick, not K8's function: the card writing
                # res_all's bytes alone (torch's fill kernel)
                extra["fill_res_all_ms"] = device_ms(
                    lambda: outs[0].fill_(0), "FillFunctor")
            print(json.dumps({"kernel": "K8", "variant": name,
                              "input": label, "rows": rows, "N": N,
                              "candidates": 5 + a[1].shape[2],
                              "lpc_mode": a[6], "ms": ms, "base_ms": base,
                              "same_as_plain": same, **extra,
                              "ptxas": regs}), flush=True)


def build_chain_probe() -> ctypes.CDLL:
    """nvcc the chain probe (CHAIN_PROBE) into a library of its own."""
    from flac_tpu_torch import kernels
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "chain_probe.cu"
    src.write_text(CHAIN_PROBE)
    lib_path = src.with_suffix(".so")
    out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the chain probe:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.flac_chain_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.flac_empty_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def chain_probe(lib=None, n: int = 1 << 16) -> dict:
    """One thread's chain, `n` dependent samples of each form: cycles a
    sample (generic: shift, add, multiply-add; folded: funnel shift,
    multiply-add) and the SM clock in cycles a ns over the run; and the
    same with a whole warp's 32 lanes each running a chain (`warp_*`), as
    the recursion warp does."""
    import torch
    lib = lib or build_chain_probe()
    buf = torch.zeros(3 + 32, dtype=torch.int64, device="cuda")
    out = {"samples": n}
    for lanes, key in ((32, "warp_"), (1, "")):
        for _ in range(2):                           # the second is timed
            if lib.flac_chain_probe(buf.data_ptr(), n, 3, 12, lanes,
                                    torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("the chain probe did not launch")
            torch.cuda.synchronize()
        generic, folded, ns = buf[:3].tolist()
        out[key + "generic_cycles_per_sample"] = generic / n
        out[key + "folded_cycles_per_sample"] = folded / n
        out[key + "cycles_per_ns"] = (generic + folded) / ns
    return out


def write_sass(libs: dict, out: Path,
               kernel: str = "restore_kernelILi8ELb0E") -> None:
    """cuobjdump's SASS of the functions whose names hold `kernel` (by
    default the narrow order-8 K3, which the main path launches) in each
    built library, one file a variant, <kernel>_sass_<variant>.txt
    (~0.8 MB each for K3; a whole library's is ~18 MB)."""
    from flac_tpu_torch import kernels
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    out.mkdir(parents=True, exist_ok=True)
    for name, (lib, _) in libs.items():
        sass = subprocess.run([str(tool), "-sass", lib._name],
                              capture_output=True, text=True).stdout
        keep = [f for f in sass.split("Function : ")
                if kernel in f.partition("\n")[0]]
        if not keep:
            continue
        slug = "".join(ch if ch.isalnum() else "_" for ch in name)
        stem = kernel.split("_kernel")[0]
        (out / f"{stem}_sass_{slug}.txt").write_text("".join(keep))


def time_k3(libs: dict, inputs: dict, probe: dict) -> None:
    """Time each built K3 library (`build`'s {name: (library, ptxas
    lines)}) on each of `k3_inputs`, in turns with "base", and print a
    JSON line each with the chain floor from `probe`."""
    import torch

    from flac_tpu_torch.ops import restore_cuda
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in libs.items():
        lib.flac_restore.argtypes = [p, i, ctypes.c_longlong, i, p, p, p, i,
                                     p, p, p, i, i, p, i, i, i, i, i, p]
        for label, (res, (order, shift, qlp, wasted, asg), mo) in \
                inputs.items():
            S, N = res.shape
            pcm = torch.empty((S, N), dtype=torch.int16, device="cuda")
            oor = torch.zeros((S // 2,), dtype=torch.bool, device="cuda")

            def run(lib=lib, res=res, order=order, shift=shift, qlp=qlp,
                    wasted=wasted, asg=asg, mo=mo, pcm=pcm, oor=oor):
                code = lib.flac_restore(
                    res.data_ptr(), res.element_size(), N, 1,
                    order.data_ptr(), shift.data_ptr(), qlp.data_ptr(), mo,
                    wasted.data_ptr(), asg.data_ptr(), pcm.data_ptr(), 1, 1,
                    oor.data_ptr(), S, N, 2, 0, 16, stream)
                if code:
                    raise SystemExit(f"K3 {name!r}: CUDA error {code}")
            ms = device_ms(run, "restore_kernel", runs=20)
            base = device_ms(lambda: run(libs["base"][0]), "restore_kernel",
                             runs=20)
            extra = (phases(lib, run, -(-S // restore_cuda.SUBS))
                     if name == "phases" else {})
            # each CTA's chain of N samples at the probe's cycles a sample
            # and clock
            floor = N * probe["folded_cycles_per_sample"] \
                / probe["cycles_per_ns"] / 1e6
            print(json.dumps({"kernel": "K3", "variant": name,
                              "input": label, "ms": ms, "base_ms": base,
                              "chain_floor_ms": floor, "S": S, "N": N,
                              "max_order": mo, **extra, "ptxas": regs}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--k6", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--k10", action="store_true")
    ap.add_argument("--k11", action="store_true")
    ap.add_argument("--k8", action="store_true")
    ap.add_argument("--sass", metavar="DIR",
                    help="write cuobjdump's SASS of the K3 and K8 "
                         "variants' function --sass-kernel names to "
                         "DIR/<kernel>_sass_<variant>.txt")
    ap.add_argument("--sass-kernel", default="restore_kernelILi8ELb0E",
                    metavar="NAME",
                    help="the function (a part of its mangled name) whose "
                         "SASS --sass writes; by default the narrow "
                         "order-8 K3, the main path's; K8's \"f64\" form "
                         "on int32 signals: "
                         "candidate_residuals_kernelIiLb0ELb1E")
    ap.add_argument("--other", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="also time DIR's pack_fields64.cu, rice_codes.cu, "
                         "restore.cu, assemble_fields.cu, frame_crc.cu, "
                         "lpc_coeffs.cu, rice_cost.cu, "
                         "candidate_residuals.cu, channel_candidates.cu "
                         "and window_autoc.cu")
    ap.add_argument("--pairs", type=int, default=0, metavar="N",
                    help="time K8, K10 and K11 against each --other "
                         "version "
                         "in N pairs too, which runs first alternating")
    args = ap.parse_args()
    others = dict(o.split("=", 1) for o in args.other)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from flac_tpu_torch.ops import pack_cuda, rice_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    every = not (args.k1 or args.k2 or args.k3 or args.k4 or args.k5
                 or args.k6 or args.k7 or args.k8 or args.k10 or args.k11)
    do_k1, do_k2, do_k3, do_k4, do_k5, do_k6, do_k7, do_k10, do_k11 = (
        every or args.k1, every or args.k2, every or args.k3,
        every or args.k4, every or args.k5, every or args.k6,
        every or args.k7, every or args.k10, every or args.k11)
    do_k8 = every or args.k8
    with ThreadPoolExecutor(8) as pool:
        # the package's own kernels, which the inputs of K4-K7 (an encode
        # batch's ops form) launch, build beside the variants
        from chip_smoke import KERNEL_MODULES
        from flac_tpu_torch import kernels as package_kernels
        fp = pool.submit(package_kernels.load_all, list(KERNEL_MODULES)) \
            if do_k4 or do_k5 or do_k6 or do_k7 or do_k8 or do_k10 \
            or do_k11 else None
        f1 = pool.submit(build, "pack_fields64", K1_VARIANTS, others) \
            if do_k1 else None
        f2 = pool.submit(build, "rice_codes", K2_VARIANTS, others) \
            if do_k2 else None
        f3 = pool.submit(build, "restore", K3_VARIANTS, others) \
            if do_k3 else None
        f4 = pool.submit(build, "assemble_fields", K4_VARIANTS, others) \
            if do_k4 else None
        f5 = pool.submit(build, "frame_crc", K5_VARIANTS, others) \
            if do_k5 else None
        f6 = pool.submit(build, "lpc_coeffs", K6_VARIANTS, others) \
            if do_k6 else None
        f7 = pool.submit(build, "rice_cost", K7_VARIANTS, others) \
            if do_k7 else None
        f8 = pool.submit(build, "candidate_residuals", K8_VARIANTS,
                         others, K8_PARENT_VARIANTS) if do_k8 else None
        f10 = pool.submit(build, "channel_candidates", K10_VARIANTS,
                          others) if do_k10 else None
        f11 = pool.submit(build, "window_autoc", K11_VARIANTS, others) \
            if do_k11 else None
        libs1 = f1.result() if f1 else {}
        libs2 = f2.result() if f2 else {}
        libs3 = f3.result() if f3 else {}
        libs4 = f4.result() if f4 else {}
        libs5 = f5.result() if f5 else {}
        libs6 = f6.result() if f6 else {}
        libs7 = f7.result() if f7 else {}
        libs8 = f8.result() if f8 else {}
        libs10 = f10.result() if f10 else {}
        libs11 = f11.result() if f11 else {}
        if fp:
            fp.result()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p = ctypes.c_void_p
    if do_k1:
        nz, pay, pb, W = k1_inputs()
        B, S = nz.shape
        words = torch.empty((B, W), dtype=torch.int64, device="cuda")
        total = torch.empty((B,), dtype=torch.int32, device="cuda")
        for name, (lib, regs) in libs1.items():
            lib.flac_pack_fields64.argtypes = [p] * 5 + [ctypes.c_int] * 3 \
                + [p]

            def run(lib=lib):
                code = lib.flac_pack_fields64(
                    nz.data_ptr(), pay.data_ptr(), pb.data_ptr(),
                    words.data_ptr(), total.data_ptr(), B, S, W, stream())
                if code:
                    raise SystemExit(f"K1 {name!r}: CUDA error {code}")
            ms = device_ms(run, "pack_fields64_kernel")
            base = device_ms(lambda: run(libs1["base"][0]),
                             "pack_fields64_kernel")
            extra = (phases(lib, run, B * pack_cuda.CLUSTER)
                     if name.endswith("phases") else {})
            print(json.dumps({"kernel": "K1", "variant": name, "ms": ms,
                              "base_ms": base, **extra, "ptxas": regs}),
                  flush=True)
    if do_k2:
        (words2d, ls, segs), kw = k2_inputs()
        L = ls.shape[0]
        res = torch.empty((kw["T"], L), dtype=torch.int32, device="cuda")
        ovf = torch.empty((L,), dtype=torch.bool, device="cuda")
        for name, (lib, regs) in libs2.items():
            lib.flac_rice_codes.argtypes = [p, ctypes.c_longlong, p, p, p,
                                            p] + [ctypes.c_int] * 6 + [p]

            def run(lib=lib):
                code = lib.flac_rice_codes(
                    words2d.data_ptr(), words2d.shape[0], ls.data_ptr(),
                    segs.data_ptr(), res.data_ptr(), ovf.data_ptr(), L,
                    kw["T"], kw["NROW"], kw["SEG"], kw["SEG"], 0, stream())
                if code:
                    raise SystemExit(f"K2 {name!r}: CUDA error {code}")
            ms = device_ms(run, "rice_codes_kernel")
            base = device_ms(lambda: run(libs2["base"][0]),
                             "rice_codes_kernel")
            extra = (phases(lib, run, -(-L // rice_cuda.STAGE_LANES))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K2", "variant": name, "ms": ms,
                              "base_ms": base, "L": L, **kw, **extra,
                              "ptxas": regs}), flush=True)
    if do_k3:
        probe = chain_probe()
        print(json.dumps({"kernel": "K3", "probe": "chain", **probe}),
              flush=True)
        time_k3(libs3, k3_inputs(), probe)
    if args.sass:
        write_sass({**libs3, **{f"k8 {n}": v for n, v in libs8.items()}},
                   Path(args.sass), args.sass_kernel)
    if do_k4:
        time_k4(libs4, k4_inputs())
    if do_k5:
        time_k5(libs5, k5_inputs())
    search = search_inputs() if do_k6 or do_k7 else {}
    if do_k6:
        time_k6(libs6, search)
    if do_k7:
        time_k7(libs7, {lv: seen["k7"] for lv, seen in search.items()})
    if do_k8:
        time_k8(libs8, k8_inputs(), others, args.pairs)
    front = front_inputs() if do_k10 or do_k11 else {}
    if do_k10:
        time_k10(libs10, {k: front[k] for k in ("-5", "-5, 256 frames")},
                 others, args.pairs)
    if do_k11:
        time_k11(libs11, front, others, args.pairs)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
