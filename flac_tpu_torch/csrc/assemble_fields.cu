// Field lists of FLAC frames (kernel K4 of flac_tpu_torch).
//
// Replaces the field-list build of flac_tpu/models/frame.py:assemble_frames
// (:70-377, with _utf8_fields and the padding), which XLA fuses into a few
// programs on the TPU.  Same contract as flac_tpu_torch/models/frame.py
// assemble_fields_plain, its plain version: every frame of the batch becomes
// a fixed-shape list of fields, each emitting nzeros zero bits and then a
// pbits-bit payload (LSB-aligned; uint32 values, or the quad layout's fused
// uint64 bit patterns, carried in int64), plus the frame's bit total before
// the padding, the quad layout's fit flag and the header bytes under the
// CRC-8.
//
// Field layout (ops/assemble_cuda.py:field_layout computes the same one on
// the host from C, N, P and the layout):
//   0 frame header (32 bits), 1..7 UTF-8 frame number, 8 blocksize tail,
//   9 rate tail, 10 CRC-8 slot; then CH fields a channel: type byte, wasted
//   unary, WS warm-up slots (32, or 64 as (high, low-16) pairs when WIDE),
//   LPC precision/shift, 32 coefficients, method/partition order,
//   partition 0's parameter prefix, G groups of 1 + per slots (a parameter
//   prefix, then the sample slots: one sample each (SAFE), four samples'
//   Rice codes fused into one payload (QUAD), or a (high, low-16) pair a
//   sample (WIDE)); then the padding and the CRC-16 slot.
//
// Design: a thread block cluster of up to 8 CTAs a frame (fewer where the
// batch would launch more than CTA_TARGET = 512 CTAs: 2 a frame at B=256;
// the cluster size is the launch's, read back as %cluster_nctarank).  Rank
// r takes the r-th share of the frame's F - 2 body slots (a whole number
// of warps' worth, so at -5 about one slot a thread; a small frame leaves
// the last ranks none), and the r-th share of the wide layout's quad fit
// work.  Each CTA loads the frame's channel scalars, and each channel's
// partition length, into its own shared memory; its threads take
// neighbouring slots, each slot computed on its own from the subframe
// choice (a sample slot reads its 1 or 4 residuals, the quad's 4 as one
// 16-byte load where the row is 16-byte aligned, and its partition's
// parameter: one division a quad) and stored at once.  The bit total and
// the fit flag are warp reductions (__reduce_add_sync, __all_sync), then
// a sum over the CTA's warps by thread 0, which stores the share's into
// rank 0's shared memory (mapa / st.shared::cluster); after one cluster
// barrier rank 0 writes the padding and CRC-16 slots, the bits, the fit
// flag and the header bytes.  No global atomic, no memset.  Every
// variable shift mirrors the plain version's torch semantics (a shift by
// a negative amount or by the type's width or more gives 0, or the sign
// for a right shift), and every clamp the plain version applies (CUDA
// leaves such shifts undefined).
//
// Bound on an H100: per -5 batch (B=64, C=2, N=4096, F=2263) the kernel
// reads the residuals (2.1 MB of int32) and writes 64*2263*16 B ~ 2.3 MB of
// fields: ~1.3 us of HBM time at 3.35 TB/s, and about 30 integer operations
// a sample.  A launch is bound by the instructions of its slots (a quad
// slot is a few hundred: the slot's decode, four samples' shifts and
// masks, the fusion's 64-bit shifts) and their dependent loads, spread
// over 512 CTAs, about 4 an SM, rather than by bytes.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CLUSTER = 8;          // CTAs a frame, at most
constexpr int CTA_TARGET = 512;     // CTAs a launch: ~4 an H100 SM
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_CHANNELS = 8;
constexpr int MAX_LPC_ORDER = 32;
constexpr int ESCAPE_K_BASE = 64;
constexpr int HEAD_FIELDS = 11;
constexpr int TYPE_CONSTANT = 0, TYPE_VERBATIM = 1, TYPE_FIXED = 2,
              TYPE_LPC = 3;
constexpr long long U32 = 0xFFFFFFFFLL;
enum { SAFE = 0, QUAD = 1, WIDE = 2 };
// channel scalars held in shared memory
// (CH_PLEN: the partition length of an order whose partitions divide N,
// else 0, where every sample takes partition 0's parameter)
enum { CH_TYPE, CH_ORDER, CH_WASTED, CH_BPS, CH_PREC, CH_SHIFT, CH_PO,
       CH_RICE2, CH_PLEN, CH_N };
constexpr int N_PTRS = 21;
constexpr int N_INTS = 19;

struct Args {
    // inputs: [B, C] int32 channel scalars, [B, C, P] params, [B, C] bool
    // use_rice2, [B, C, N] int32 residuals, [B, C, 32] warm-up (int32 or
    // int64), [B, C, N] signal (int32 or int64), [B, C, 32] int32 qcoeffs,
    // [B] int32 assignment, [B] int64 frame numbers
    const int *type_, *order, *wasted, *bps_eff, *precision, *shift, *po;
    const int* params;
    const unsigned char* rice2;
    const int* residual;
    const void* warmup;
    const void* signal;
    const int* qcoeffs;
    const int* assignment;
    const long long* frame_numbers;
    // outputs: [B, F] nzeros, payload, pbits; [B] bits, ok, hdr_bytes
    int* nzeros;
    long long* payload;
    int* pbits;
    int* bits;
    unsigned char* ok;
    int* hdr_bytes;
    int B, C, N, P, F, CH, WS, G, per, m_min, max_po;
    long long hdr_base;          // the header word without the channel code
    long long bs_tail, sr_tail;
    int bs_tail_bits, sr_tail_bits;
    int warm64, sig64;           // warm-up / signal rows are int64
    int fit_quads;               // the quad fit flag in the WIDE layout
};

struct Field {
    int nz;
    long long pay;
    int pb;
};

// torch's shift semantics on int64 and int32
__device__ __forceinline__ long long shl(long long a, long long s) {
    return (s < 0 || s >= 64) ? 0 : (long long)((unsigned long long)a << s);
}
__device__ __forceinline__ long long shr(long long a, long long s) {
    return (s < 0 || s >= 64) ? (a >> 63) : (a >> s);
}
__device__ __forceinline__ int shl32(int a, int s) {
    return (s < 0 || s >= 32) ? 0 : (int)((unsigned int)a << s);
}
__device__ __forceinline__ int shr32(int a, int s) {
    return (s < 0 || s >= 32) ? (a >> 31) : (a >> s);
}
__device__ __forceinline__ long long low_mask(long long nbits) {
    return shl(1, nbits) - 1;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int add32(int a, int b) {      // int32 wrap
    return (int)((unsigned int)a + (unsigned int)b);
}

// The Rice parameter of sample n: the partition's for an order whose
// partitions divide N (of plen samples), else partition 0's (plen 0: the
// plain version's first-match expansion).
__device__ __forceinline__ int rice_k(const int* params, int plen, int n) {
    return params[plen ? n / plen : 0];
}

// A parameter prefix: k in plen bits, or an escape marker and a 5-bit raw
// width; no bits where the prefix is inactive (its payload stays).
__device__ __forceinline__ Field prefix(int kv, int rice2, bool active) {
    const long long plen = rice2 ? 5 : 4;
    Field f;
    f.nz = 0;
    if (kv >= ESCAPE_K_BASE) {
        f.pay = (((shl(1, plen) - 1) << 5) & U32)
                | ((long long)(kv - ESCAPE_K_BASE) & U32);
        f.pb = (int)plen + 5;
    } else {
        f.pay = (long long)kv & U32;
        f.pb = (int)plen;
    }
    if (!active) f.pb = 0;
    return f;
}

// One sample's field (in the WIDE layout the high half's); r and k are its
// residual and Rice parameter where the subframe has residuals.
template <bool WIDE_SAMPLES>
__device__ __forceinline__ Field sample(const Args& a, const int* ch, int r,
                                       int k, const void* sig, int n) {
    const int type = ch[CH_TYPE], bps = ch[CH_BPS];
    const bool has_res = type == TYPE_FIXED || type == TYPE_LPC;
    Field f{0, 0, 0};
    if (has_res && n >= ch[CH_ORDER]) {
        const unsigned int u32 =
            ((unsigned int)r << 1) ^ (unsigned int)(r >> 31);
        const long long u = (long long)u32;
        if ((unsigned int)k < 32u) {                 // the common case
            const unsigned int bit = 1u << k;
            f.nz = (int)(u32 >> k);
            f.pay = (long long)(bit | (u32 & (bit - 1u)));
            f.pb = k + 1;
        } else if (k >= ESCAPE_K_BASE) {
            const int rawb = k - ESCAPE_K_BASE;
            f.pay = ((long long)r & U32) & low_mask(clampi(rawb, 0, 31));
            f.pb = rawb;
        } else {
            f.nz = (int)shr(u, k);
            f.pay = (shl(1, k) | (u & (shl(1, k) - 1))) & U32;
            f.pb = k + 1;
        }
    } else if (type == TYPE_VERBATIM) {
        const long long x = a.sig64 ? ((const long long*)sig)[n]
                                    : (long long)((const int*)sig)[n];
        if (WIDE_SAMPLES) {
            f.pay = (x & (shl(1, bps) - 1)) >> 16;
            f.pb = clampi(bps - 16, 0, 17);
        } else {
            const long long smask =
                bps >= 32 ? U32 : low_mask(clampi(bps, 0, 31));
            f.pay = (x & U32) & smask;
            f.pb = bps;
        }
    }
    return f;
}

// The residuals of quad qi: one 16-byte load where the row allows it;
// none where the subframe has no residuals.
__device__ __forceinline__ int4 quad_residuals(const int* ch,
                                               const int* res, int qi) {
    const int type = ch[CH_TYPE];
    if (type != TYPE_FIXED && type != TYPE_LPC) return make_int4(0, 0, 0, 0);
    const int* p = res + 4 * qi;
    if (((uintptr_t)p & 15) == 0)
        return __ldg(reinterpret_cast<const int4*>(p));
    return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Quad qi's fused field: sample 4qi's unary zeros stay in nz, the rest of
// the run concatenates into one payload.  In the quad layout a partition
// has at least 4 samples (the layout's m_min), so a quad's samples span at
// most two partitions: one division finds both parameters.
template <bool WIDE_SAMPLES>
__device__ __forceinline__ Field fuse(const Args& a, const int* ch,
                                      const int* res, const void* sig,
                                      const int* params, int qi) {
    const int4 r4 = quad_residuals(ch, res, qi);
    const int r[4] = {r4.x, r4.y, r4.z, r4.w};
    const int n0 = 4 * qi, plen = ch[CH_PLEN];
    int k[4];
    if (WIDE_SAMPLES) {
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = rice_k(params, plen, n0 + i);
    } else {
        const int p0 = plen ? n0 / plen : 0;
        const int next = plen ? (p0 + 1) * plen : INT_MAX;
        const int k0 = params[p0];
        const int k1 = n0 + 3 >= next ? params[p0 + 1] : k0;
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = n0 + i >= next ? k1 : k0;
    }
    Field f = sample<WIDE_SAMPLES>(a, ch, r[0], k[0], sig, n0);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        const Field s = sample<WIDE_SAMPLES>(a, ch, r[i], k[i], sig, n0 + i);
        const int step = add32(s.nz, s.pb);
        f.pay = (long long)((unsigned long long)f.pay << clampi(step, 0, 63))
                | s.pay;
        f.pb = add32(f.pb, step);
    }
    return f;
}

__device__ __forceinline__ int utf8_len(long long n) {
    return 1 + (n >= 0x80LL) + (n >= 0x800LL) + (n >= 0x10000LL)
           + (n >= 0x200000LL) + (n >= 0x4000000LL) + (n >= 0x80000000LL)
           + (n >= 0x1000000000LL);
}

// Byte j of the UTF-8 coded frame number n (n < 2^36), 0 past its length.
__device__ __forceinline__ long long utf8_byte(long long n, int j) {
    const int L = utf8_len(n);
    if (j >= L) return 0;
    const int sh = clampi(6 * (L - 1 - j), 0, 63);
    if (j > 0) return (0x80 | (shr(n, sh) & 0x3F)) & U32;
    if (L == 1) return n & U32;
    const long long lead = (0xFF << (8 - L)) & 0xFF;
    return (lead | (shr(n, sh) & (shl(1, clampi(7 - L, 0, 7)) - 1))) & U32;
}

__device__ __forceinline__ Field head_field(const Args& a, int b, int s) {
    Field f{0, 0, 0};
    if (s == 0) {
        const int asg = a.assignment[b];
        const int ch_code = a.C == 2 ? (asg == 0 ? 1 : 7 + asg) : a.C - 1;
        f.pay = (a.hdr_base | shl(ch_code, 4)) & U32;
        f.pb = 32;
    } else if (s <= 7) {
        const int j = s - 1;
        const long long n = a.frame_numbers[b];
        f.pay = utf8_byte(n, j);
        f.pb = j < utf8_len(n) ? 8 : 0;
    } else if (s == 8) {
        f.pay = a.bs_tail;
        f.pb = a.bs_tail_bits;
    } else if (s == 9) {
        f.pay = a.sr_tail;
        f.pb = a.sr_tail_bits;
    } else {
        f.pb = 8;                               // the CRC-8 slot
    }
    return f;
}

// Field r of channel c of frame b.
template <int LAYOUT>
__device__ __forceinline__ Field channel_field(const Args& a, int b, int c,
                                               int r, const int* ch,
                                               bool& fit) {
    const size_t bc = (size_t)b * a.C + c;
    const int type = ch[CH_TYPE], order = ch[CH_ORDER];
    const int wasted = ch[CH_WASTED], bps = ch[CH_BPS];
    const int prec = ch[CH_PREC], po = ch[CH_PO], rice2 = ch[CH_RICE2];
    const bool is_c = type == TYPE_CONSTANT, is_v = type == TYPE_VERBATIM;
    const bool is_f = type == TYPE_FIXED, is_l = type == TYPE_LPC;
    const bool has_res = is_f || is_l;
    const int* params = a.params + bc * a.P;
    Field f{0, 0, 0};
    if (r == 0) {                                        // type byte
        const int tb = is_c ? 0x00 : is_v ? 0x02
                     : is_f ? (0x10 | shl32(order, 1))
                            : (0x40 | shl32(order - 1, 1));
        f.pay = (long long)(tb | (int)(wasted > 0)) & U32;
        f.pb = 8;
    } else if (r == 1) {                                 // wasted unary
        const int wflag = wasted > 0;
        f.nz = wasted - 1 > 0 ? wasted - 1 : 0;
        f.pay = wflag;
        f.pb = wflag;
    } else if (r < 2 + a.WS) {                           // warm-up
        const int j = r - 2, slot = LAYOUT == WIDE ? j >> 1 : j;
        const size_t at = bc * MAX_LPC_ORDER + slot;
        const long long w = a.warm64 ? ((const long long*)a.warmup)[at]
                                     : (long long)((const int*)a.warmup)[at];
        const long long wm = w & (shl(1, bps) - 1);
        const bool act = (has_res && slot < order) || (is_c && slot == 0);
        if (LAYOUT != WIDE) {
            f.pay = wm & U32;
            f.pb = act ? bps : 0;
        } else if ((j & 1) == 0) {
            f.pay = wm >> 16;
            f.pb = act ? clampi(bps - 16, 0, 17) : 0;
        } else {
            f.pay = wm & 0xFFFF;
            f.pb = act ? (bps < 16 ? bps : 16) : 0;
        }
    } else if (r == 2 + a.WS) {                          // precision/shift
        f.pay = (long long)(shl32(prec - 1, 5) | ch[CH_SHIFT]) & U32;
        f.pb = is_l ? 9 : 0;
    } else if (r < 3 + a.WS + MAX_LPC_ORDER) {           // coefficients
        const int j = r - 3 - a.WS;
        f.pay = ((long long)a.qcoeffs[bc * MAX_LPC_ORDER + j]
                 & (shl(1, prec) - 1)) & U32;
        f.pb = (is_l && j < order) ? prec : 0;
    } else if (r == 3 + a.WS + MAX_LPC_ORDER) {          // method/order
        f.pay = ((long long)rice2 << 4) | (long long)po;
        f.pb = has_res ? 6 : 0;
    } else if (r == 4 + a.WS + MAX_LPC_ORDER) {          // prefix 0
        f = prefix(params[0], rice2, has_res);
    } else {                                             // the groups
        const int q = r - 5 - a.WS - MAX_LPC_ORDER;
        const int g = q / (1 + a.per), i = q - g * (1 + a.per);
        const int* res = a.residual + bc * a.N;
        const char* sig = (const char*)a.signal
                          + bc * a.N * (a.sig64 ? 8 : 4);
        if (i == 0) {
            // a partition starts at group g iff g is a multiple of
            // 2^(max_po - po)
            const int ratio = shr32(1 << a.max_po, po);
            const bool act = has_res && g > 0 && (g & (ratio - 1)) == 0;
            f = prefix(rice_k(params, ch[CH_PLEN], g * a.m_min), rice2, act);
        } else if (LAYOUT == QUAD) {
            f = fuse<false>(a, ch, res, sig, params, g * a.per + i - 1);
            fit = fit && f.pb <= 63;
        } else if (LAYOUT == WIDE) {
            const int n = g * a.m_min + ((i - 1) >> 1);
            if (((i - 1) & 1) == 0) {
                f = sample<true>(a, ch, has_res ? __ldg(res + n) : 0,
                                 rice_k(params, ch[CH_PLEN], n), sig, n);
            } else if (is_v) {                           // the low half
                const long long x =
                    a.sig64 ? ((const long long*)sig)[n]
                            : (long long)((const int*)sig)[n];
                f.pay = (x & (shl(1, bps) - 1)) & 0xFFFF;
                f.pb = bps < 16 ? bps : 16;
            }
        } else {
            const int n = g * a.m_min + i - 1;
            f = sample<false>(a, ch, has_res ? __ldg(res + n) : 0,
                              rice_k(params, ch[CH_PLEN], n), sig, n);
        }
    }
    return f;
}

#include "cluster.cuh"

// The first of rank r's items when n are shared out among nc ranks in
// whole warps' worth.
__device__ __forceinline__ int share_begin(int n, int r, int nc) {
    const int share = ((n + nc - 1) / nc + 31) & ~31;
    return min(n, r * share);
}

struct Smem {
    int ch[MAX_CHANNELS][CH_N];          // the frame's channel scalars
    unsigned warp_bits[WARPS];
    unsigned warp_misfit[WARPS];
    unsigned rank_bits[CLUSTER];         // in rank 0: every rank's share
    unsigned rank_misfit[CLUSTER];
};

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
assemble_fields_kernel(const Args a) {
    __shared__ Smem sh;
    cluster_arrive_relaxed();
    const int rank = cluster_rank(), nc = cluster_size();
    const int b = blockIdx.x / nc;
    const size_t bc0 = (size_t)b * a.C;
    if (threadIdx.x < a.C) {
        const size_t bc = bc0 + threadIdx.x;
        int* row = sh.ch[threadIdx.x];
        row[CH_TYPE] = a.type_[bc];
        row[CH_ORDER] = a.order[bc];
        row[CH_WASTED] = a.wasted[bc];
        row[CH_BPS] = a.bps_eff[bc];
        row[CH_PREC] = a.precision[bc];
        row[CH_SHIFT] = a.shift[bc];
        const int po = a.po[bc];
        row[CH_PO] = po;
        row[CH_RICE2] = a.rice2[bc] != 0;
        row[CH_PLEN] = po >= 0 && po <= a.max_po && a.N % (1 << po) == 0
                       ? a.N >> po : 0;
    }
    __syncthreads();

    int* nz_row = a.nzeros + (size_t)b * a.F;
    long long* pay_row = a.payload + (size_t)b * a.F;
    int* pb_row = a.pbits + (size_t)b * a.F;
    const int body = a.F - 2;               // every field but the last two
    unsigned int bits = 0;
    bool fit = true;
    const int s1 = share_begin(body, rank + 1, nc);
    for (int s = share_begin(body, rank, nc) + threadIdx.x; s < s1;
         s += THREADS) {
        Field f;
        if (s < HEAD_FIELDS) {
            f = head_field(a, b, s);
        } else {
            const int c = (s - HEAD_FIELDS) / a.CH;
            f = channel_field<LAYOUT>(a, b, c, s - HEAD_FIELDS - c * a.CH,
                                      sh.ch[c], fit);
        }
        nz_row[s] = f.nz;
        pay_row[s] = f.pay;
        pb_row[s] = f.pb;
        bits += (unsigned int)f.nz + (unsigned int)f.pb;
    }
    if (LAYOUT == WIDE && a.fit_quads) {
        // the quad layout's fit flag over the wide samples' fields
        const int quads = a.N >> 2, work = a.C * quads;
        const int t1 = share_begin(work, rank + 1, nc);
        for (int t = share_begin(work, rank, nc) + threadIdx.x; t < t1;
             t += THREADS) {
            const int c = t / quads;
            const size_t bc = bc0 + c;
            const Field f = fuse<true>(
                a, sh.ch[c], a.residual + bc * a.N,
                (const char*)a.signal + bc * a.N * (a.sig64 ? 8 : 4),
                a.params + bc * a.P, t - c * quads);
            fit = fit && f.pb <= 63;
        }
    }
    // the share's bit total and fit flag: warps, then the CTA, then rank 0
    bits = __reduce_add_sync(FULL, bits);
    const bool warp_fit = __all_sync(FULL, fit);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        sh.warp_bits[warp] = bits;
        sh.warp_misfit[warp] = warp_fit ? 0u : 1u;
    }
    __syncthreads();
    cluster_wait();
    if (threadIdx.x == 0) {
        unsigned total = 0, misfit = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            total += sh.warp_bits[w];
            misfit |= sh.warp_misfit[w];
        }
        store_remote(&sh.rank_bits[rank], 0, total);
        store_remote(&sh.rank_misfit[rank], 0, misfit);
    }
    cluster_barrier();
    if (rank == 0 && threadIdx.x == 0) {
        unsigned total = 0, misfit = 0;
#pragma unroll
        for (int r = 0; r < nc; ++r) {
            total += sh.rank_bits[r];
            misfit |= sh.rank_misfit[r];
        }
        nz_row[body] = (int)((0u - total) & 7u);          // the padding
        pay_row[body] = 0;
        pb_row[body] = 0;
        nz_row[body + 1] = 0;                             // the CRC-16 slot
        pay_row[body + 1] = 0;
        pb_row[body + 1] = 16;
        a.bits[b] = (int)total;
        a.ok[b] = misfit ? 0 : 1;
        a.hdr_bytes[b] = 4 + utf8_len(a.frame_numbers[b])
                         + a.bs_tail_bits / 8 + a.sr_tail_bits / 8;
    }
}

}  // namespace

extern "C" {

// Build the field lists of B frames.  ptrs: the N_PTRS device pointers of
// Args in order (contiguous row-major tensors); ints: B, C, N, P, F, CH, WS,
// G, per, m_min, max_po, hdr_base, bs_tail, bs_tail_bits, sr_tail,
// sr_tail_bits, warm64, sig64, fit_quads; layout: SAFE, QUAD or WIDE.
// Returns the CUDA error code of the launch (0 on success).
int flac_assemble_fields(const void* const* ptrs, int n_ptrs,
                         const long long* ints, int n_ints, int layout,
                         void* stream) {
    if (n_ptrs != N_PTRS || n_ints != N_INTS)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.type_ = (const int*)ptrs[0];
    a.order = (const int*)ptrs[1];
    a.wasted = (const int*)ptrs[2];
    a.bps_eff = (const int*)ptrs[3];
    a.precision = (const int*)ptrs[4];
    a.shift = (const int*)ptrs[5];
    a.po = (const int*)ptrs[6];
    a.params = (const int*)ptrs[7];
    a.rice2 = (const unsigned char*)ptrs[8];
    a.residual = (const int*)ptrs[9];
    a.warmup = ptrs[10];
    a.signal = ptrs[11];
    a.qcoeffs = (const int*)ptrs[12];
    a.assignment = (const int*)ptrs[13];
    a.frame_numbers = (const long long*)ptrs[14];
    a.nzeros = (int*)ptrs[15];
    a.payload = (long long*)ptrs[16];
    a.pbits = (int*)ptrs[17];
    a.bits = (int*)ptrs[18];
    a.ok = (unsigned char*)ptrs[19];
    a.hdr_bytes = (int*)ptrs[20];
    a.B = (int)ints[0];
    a.C = (int)ints[1];
    a.N = (int)ints[2];
    a.P = (int)ints[3];
    a.F = (int)ints[4];
    a.CH = (int)ints[5];
    a.WS = (int)ints[6];
    a.G = (int)ints[7];
    a.per = (int)ints[8];
    a.m_min = (int)ints[9];
    a.max_po = (int)ints[10];
    a.hdr_base = ints[11];
    a.bs_tail = ints[12];
    a.bs_tail_bits = (int)ints[13];
    a.sr_tail = ints[14];
    a.sr_tail_bits = (int)ints[15];
    a.warm64 = (int)ints[16];
    a.sig64 = (int)ints[17];
    a.fit_quads = (int)ints[18];
    if (a.B <= 0) return 0;
    if (a.C < 1 || a.C > MAX_CHANNELS || a.N < 1 || a.P < 1
        || a.F != HEAD_FIELDS + a.C * a.CH + 2
        || a.CH != 5 + a.WS + MAX_LPC_ORDER + a.G * (1 + a.per))
        return (int)cudaErrorInvalidValue;
    // a cluster of up to CLUSTER CTAs a frame, fewer where the batch
    // would launch more than CTA_TARGET CTAs
    int nc = CLUSTER;
    while (nc > 1 && (long long)a.B * nc > CTA_TARGET) nc >>= 1;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B * nc, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    switch (layout) {
        case SAFE: e = cudaLaunchKernelEx(&cfg, assemble_fields_kernel<SAFE>,
                                          a);
                   break;
        case QUAD: e = cudaLaunchKernelEx(&cfg, assemble_fields_kernel<QUAD>,
                                          a);
                   break;
        case WIDE: e = cudaLaunchKernelEx(&cfg, assemble_fields_kernel<WIDE>,
                                          a);
                   break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
