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
// Design: one CTA of THREADS threads a frame.  The frame's channel scalars
// go to shared memory; the threads stride over the frame's field slots,
// each slot computed on its own from the subframe choice (a sample slot
// reads its 1 or 4 residuals and its partition's parameter) and stored at
// once, neighbouring threads on neighbouring slots.  The bit total and
// the fit flag are block reductions (shared-memory atomics); thread 0 then
// writes the padding and CRC-16 slots.  Every variable shift mirrors the
// plain version's torch semantics (a shift by a negative amount or by the
// type's width or more gives 0, or the sign for a right shift), and every
// clamp the plain version applies (CUDA leaves such shifts undefined).
//
// Bound on an H100: per -5 batch (B=64, C=2, N=4096, F=2263) the kernel
// reads the residuals (2.1 MB of int32) and writes 64*2263*16 B ~ 2.3 MB of
// fields: ~1.3 us of HBM time at 3.35 TB/s, and about 30 integer operations
// a sample.  64 CTAs on 132 SMs: a launch is a few dependent memory
// latencies, not bytes; spreading a frame over several CTAs is a later
// design's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHANNELS = 8;
constexpr int MAX_LPC_ORDER = 32;
constexpr int ESCAPE_K_BASE = 64;
constexpr int HEAD_FIELDS = 11;
constexpr int TYPE_CONSTANT = 0, TYPE_VERBATIM = 1, TYPE_FIXED = 2,
              TYPE_LPC = 3;
constexpr long long U32 = 0xFFFFFFFFLL;
enum { SAFE = 0, QUAD = 1, WIDE = 2 };
// channel scalars held in shared memory
enum { CH_TYPE, CH_ORDER, CH_WASTED, CH_BPS, CH_PREC, CH_SHIFT, CH_PO,
       CH_RICE2, CH_N };
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
// partitions divide N, else partition 0's (the plain version's first-match
// expansion).
__device__ __forceinline__ int rice_k(const int* params, int N, int po,
                                      int max_po, int n) {
    if (po >= 0 && po <= max_po && N % (1 << po) == 0)
        return params[n / (N >> po)];
    return params[0];
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

// One sample's field (in the WIDE layout the high half's).
template <bool WIDE_SAMPLES>
__device__ __forceinline__ Field sample(const Args& a, const int* ch,
                                       const int* res, const void* sig,
                                       const int* params, int n) {
    const int type = ch[CH_TYPE], bps = ch[CH_BPS];
    const bool has_res = type == TYPE_FIXED || type == TYPE_LPC;
    Field f{0, 0, 0};
    if (has_res && n >= ch[CH_ORDER]) {
        const int r = res[n];
        const long long u =
            (long long)(((unsigned int)r << 1) ^ (unsigned int)(r >> 31));
        const int k = rice_k(params, a.N, ch[CH_PO], a.max_po, n);
        if (k >= ESCAPE_K_BASE) {
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

// Quad qi's fused field: sample 4qi's unary zeros stay in nz, the rest of
// the run concatenates into one payload.
template <bool WIDE_SAMPLES>
__device__ __forceinline__ Field fuse(const Args& a, const int* ch,
                                      const int* res, const void* sig,
                                      const int* params, int qi) {
    Field f = sample<WIDE_SAMPLES>(a, ch, res, sig, params, 4 * qi);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        const Field s = sample<WIDE_SAMPLES>(a, ch, res, sig, params,
                                             4 * qi + i);
        const int step = add32(s.nz, s.pb);
        f.pay = shl(f.pay, clampi(step, 0, 63)) | s.pay;
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
            f = prefix(rice_k(params, a.N, po, a.max_po, g * a.m_min),
                       rice2, act);
        } else if (LAYOUT == QUAD) {
            f = fuse<false>(a, ch, res, sig, params, g * a.per + i - 1);
            fit = fit && f.pb <= 63;
        } else if (LAYOUT == WIDE) {
            const int n = g * a.m_min + ((i - 1) >> 1);
            if (((i - 1) & 1) == 0) {
                f = sample<true>(a, ch, res, sig, params, n);
            } else if (is_v) {                           // the low half
                const long long x =
                    a.sig64 ? ((const long long*)sig)[n]
                            : (long long)((const int*)sig)[n];
                f.pay = (x & (shl(1, bps) - 1)) & 0xFFFF;
                f.pb = bps < 16 ? bps : 16;
            }
        } else {
            f = sample<false>(a, ch, res, sig, params,
                              g * a.m_min + i - 1);
        }
    }
    return f;
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS) assemble_fields_kernel(
        const Args a) {
    __shared__ int ch[MAX_CHANNELS][CH_N];
    __shared__ unsigned int s_bits;
    __shared__ int s_misfit;
    const int b = blockIdx.x;
    const size_t bc0 = (size_t)b * a.C;
    if (threadIdx.x < a.C) {
        const size_t bc = bc0 + threadIdx.x;
        int* row = ch[threadIdx.x];
        row[CH_TYPE] = a.type_[bc];
        row[CH_ORDER] = a.order[bc];
        row[CH_WASTED] = a.wasted[bc];
        row[CH_BPS] = a.bps_eff[bc];
        row[CH_PREC] = a.precision[bc];
        row[CH_SHIFT] = a.shift[bc];
        row[CH_PO] = a.po[bc];
        row[CH_RICE2] = a.rice2[bc] != 0;
    }
    if (threadIdx.x == 0) {
        s_bits = 0;
        s_misfit = 0;
    }
    __syncthreads();

    int* nz_row = a.nzeros + (size_t)b * a.F;
    long long* pay_row = a.payload + (size_t)b * a.F;
    int* pb_row = a.pbits + (size_t)b * a.F;
    const int body = a.F - 2;               // every field but the last two
    unsigned int bits = 0;
    bool fit = true;
    for (int s = threadIdx.x; s < body; s += THREADS) {
        Field f;
        if (s < HEAD_FIELDS) {
            f = head_field(a, b, s);
        } else {
            const int c = (s - HEAD_FIELDS) / a.CH;
            f = channel_field<LAYOUT>(a, b, c, s - HEAD_FIELDS - c * a.CH,
                                      ch[c], fit);
        }
        nz_row[s] = f.nz;
        pay_row[s] = f.pay;
        pb_row[s] = f.pb;
        bits += (unsigned int)f.nz + (unsigned int)f.pb;
    }
    if (LAYOUT == WIDE && a.fit_quads) {
        // the quad layout's fit flag over the wide samples' fields
        const int quads = a.N >> 2;
        for (int t = threadIdx.x; t < a.C * quads; t += THREADS) {
            const int c = t / quads;
            const size_t bc = bc0 + c;
            const Field f = fuse<true>(
                a, ch[c], a.residual + bc * a.N,
                (const char*)a.signal + bc * a.N * (a.sig64 ? 8 : 4),
                a.params + bc * a.P, t - c * quads);
            fit = fit && f.pb <= 63;
        }
    }
    if (bits) atomicAdd(&s_bits, bits);
    if (!fit) s_misfit = 1;
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int total = s_bits;
        nz_row[body] = (int)((0u - total) & 7u);          // the padding
        pay_row[body] = 0;
        pb_row[body] = 0;
        nz_row[body + 1] = 0;                             // the CRC-16 slot
        pay_row[body + 1] = 0;
        pb_row[body + 1] = 16;
        a.bits[b] = (int)total;
        a.ok[b] = s_misfit ? 0 : 1;
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
    cudaStream_t s = (cudaStream_t)stream;
    switch (layout) {
        case SAFE: assemble_fields_kernel<SAFE><<<a.B, THREADS, 0, s>>>(a);
                   break;
        case QUAD: assemble_fields_kernel<QUAD><<<a.B, THREADS, 0, s>>>(a);
                   break;
        case WIDE: assemble_fields_kernel<WIDE><<<a.B, THREADS, 0, s>>>(a);
                   break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
