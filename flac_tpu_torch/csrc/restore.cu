// LPC restore, wasted-bit shift and stereo undo of the decoders (kernel K3
// of flac_tpu_torch).
//
// Replaces flac_tpu/ops/bitunpack.py:53-120, restore_undo_body: an XLA
// lax.scan over the samples of every subframe of a batch, which both the
// device engine (after the code scan) and the "fast" engine (after the
// native full parse) run as one compiled program.  Same contract as its
// plain version, flac_tpu_torch/ops/bitunpack.py restore_undo_body:
//
//   res   [S, >= N] residuals, int16, int32 or int64 (row stride rstride)
//   order, shift, wasted [S] int32; qlp [S, MO] int32 (MO >= 1); asg [B]
//   int32
//   -> pcm [B, C, N] (int16 with out16, else int32, int64 when wide),
//      oor [B] bool (stream_decoder.c:2458-2472's bps-range check, taken
//      before any narrowing; the caller zeroes it, bps = 0 disables it)
//
// Per subframe s and sample n (lpc.c:978 restore, S = B * C):
//   x[n] = r[n]                                   for n < order[s]
//   x[n] = r[n] + ((sum_i qlp[s,i] * x[n-1-i]) >> shift[s])   otherwise
// with the sum in int64 (wrapping) and x in int32 (wrapping) for narrow
// batches, in int64 for wide ones; then x << wasted[s] in the sample type;
// then, for C == 2, the stereo undo of stream_decoder.c:3476-3526
// (assignment 1 left/side, 2 right/side, 3 mid/side with mid = (a << 1) |
// (b & 1) and an arithmetic >> 1); then the range flag; then the narrowing
// to int16.  Shifts follow PyTorch's rule, which the plain version obeys: a
// left shift by a negative amount or by the width or more gives 0, such a
// right shift gives the sign.  Signed overflow is undefined in C++, so
// every wrapping sum, product and left shift is done in the unsigned type.
//
// Design for Hopper.  The recursion is serial within a subframe and the >>
// makes it non-linear, so there is no parallel scan: the floor of a
// subframe is the latency of the chain through the newest tap.  A CTA of
// 128 threads takes 32 subframes (16 stereo frames: s = frame * C +
// channel, so a frame never straddles a CTA when C == 2) and splits the
// work by warp:
//
//   warp 0, the recursion: a thread a subframe, doing nothing but the
//     chain.  It keeps MO running partial sums ("lookahead accumulators")
//     in registers: P[m] collects q[j] * x[m-1-j] as soon as each x is
//     known, so when x[n] is out only P[n+1] += q[0] * x[n] sits on the
//     chain; the MO - 1 other multiply-adds fill its latency.  Wrapping
//     sums are exact in any order (mod 2^64).  A warp whose subframes all
//     have taps of 16 signed bits and shifts 0..31 takes the folded form
//     x = (P + (r << sh)) >> sh, exact there (|P| < 2^51, |r 2^sh| < 2^62):
//     the residual joins P off the chain and x is one funnel shift of P
//     (shf.r), so the chain is a mad.wide.s32 and a shf; and the older
//     taps' sums go to the FP64 pipe as doubles, exact below 2^53 (one
//     DFMA a tap, where the integer pipe takes a 64-bit product and two
//     adds).  Other warps, the warm-up rounds and wide batches take the
//     generic form r + (P >> sh) in int64 (see ops/restore_cuda.py,
//     `mirror_restore`, for the host mirror of both and of the rule).
//     The accumulators live in a circular set of MO registers indexed by
//     n mod MO: a template on the order bucket MO (1, 2, 4, 8, 12, 16, 32;
//     a batch without taps runs MO 1 on a zero tap) and rounds of R
//     samples (a multiple of MO) keep every index a constant.
//   warp 1, the producer: streams the CTA's residual rows in chunks of K
//     samples into a ring of IN_STAGES stages in shared memory.  Where rows
//     are 16-byte aligned, each lane issues one cp.async.bulk for its row's
//     chunk, completing on the stage's "full" mbarrier; otherwise (and for
//     a tail chunk whose bytes are not a multiple of 16) the warp copies
//     with plain loads, coalesced along the samples.  Ring rows are padded
//     by 16 bytes, so the recursion warp's 16-byte reads of 32 rows are free
//     of bank conflicts.
//   warps 2-3, the epilogue: drain the recursion's x ring (OUT_STAGES
//     stages, 16-byte groups swizzled by the row, so both the recursion's
//     column writes and the epilogue's row reads are free of conflicts)
//     coalesced along the samples: the wasted-bit shift, the stereo undo
//     with both channel rows of a frame in shared memory (no shuffle), the
//     range flag (a warp ballot, one store of 1 a frame at the end), the
//     narrowing to int16 and 8- or 16-byte stores.
//
// Bound on an H100: a full -5 batch (1024 stereo frames of 4096 samples,
// S = 2048) reads res once (33.5 MB in int32) and writes pcm once (16.8 MB
// in int16): ~50 MB, ~0.015 ms at 3.35 TB/s.  Its 64 CTAs each run a chain
// of 4096 samples: ~20 cycles a sample on an H100 (a funnel shift, the
// 64-bit multiply-add), ~0.04 ms at the SM clock, the kernel's floor; the
// recursion warp's own instruction stream sits above it (kernel_variants.py
// --k3 measures both, PERF.md has the numbers).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SUBS = 32;          // subframes a CTA (one recursion lane each)
constexpr int EPI_WARPS = 2;
constexpr int THREADS = 32 * (2 + EPI_WARPS);
constexpr int K = 96;             // samples a chunk (a multiple of every R)
constexpr int IN_STAGES = 3;      // residual ring
constexpr int OUT_STAGES = 2;     // x ring
constexpr int IN_PAD = 16;        // bytes after each residual ring row
// int16 samples in 16 bytes: the least round of the recursion (its 16-byte
// reads of int16 residuals), and the unit of N that keeps every pcm row
// 16-byte aligned (the wrapper's vec_out rule)
constexpr int GROUP = 8;
constexpr int BARS_BYTES = 128;   // the mbarriers, at the start
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ASG_LEFT_SIDE = 1;
constexpr int ASG_RIGHT_SIDE = 2;
constexpr int ASG_MID_SIDE = 3;
static_assert(2 * (IN_STAGES + OUT_STAGES) * 8 <= BARS_BYTES, "barriers");

// samples a round of the recursion: a multiple of MO (the accumulators'
// register index is n mod MO) and of GROUP; long, so that a round's vote,
// branch and first load are shared by many samples
template <int MO>
__host__ __device__ constexpr int round_len() {
    return MO == 12 ? 3 * GROUP : 4 * GROUP;
}
static_assert(K % (3 * GROUP) == 0 && K % 32 == 0, "K: whole rounds");

// bytes of dynamic shared memory a launch uses
__host__ __device__ constexpr int in_pitch(int rb) { return K * rb + IN_PAD; }
__host__ __device__ constexpr int in_stage_bytes(int rb) {
    return SUBS * in_pitch(rb);
}
__host__ __device__ constexpr int out_stage_bytes(int xb) {
    return SUBS * K * xb;
}
__host__ __device__ constexpr int smem_bytes(int rb, int xb) {
    return BARS_BYTES + IN_STAGES * in_stage_bytes(rb) +
           OUT_STAGES * out_stage_bytes(xb);
}

// ---- PTX helpers ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
    uint32_t ok;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    return ok != 0;
}
// wait for the phase of `parity` to complete; a wait of ~2 s (a deadlock)
// traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    if (bar_try(bar, parity)) return;
    const long long t0 = clock64();
    while (!bar_try(bar, parity))
        if (clock64() - t0 > (1LL << 32)) __trap();
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// a * b + c for int32 factors in one IMAD.WIDE (nvcc otherwise widens both
// factors to 64 bits and multiplies 64 x 64, about five instructions)
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
    long long d;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
    return d;
}
// a * b + c for int32 factors as two 32-bit multiply-adds, the low word's
// carry into the high word's: the folded chain's step.  ptxas compiles
// mad.wide.s32 with a computed addend into a bare 64-bit product and two
// adds, one more dependent instruction on the chain.
__device__ __forceinline__ long long mad_cc(int a, int b, long long c) {
    unsigned lo, hi;
    asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\t"
        "madc.hi.s32 %1, %2, %3, %5;"
        : "=r"(lo), "=r"(hi)
        : "r"(a), "r"(b), "r"((unsigned)c),
          "r"((unsigned)((unsigned long long)c >> 32)));
    return (long long)(((unsigned long long)hi << 32) | lo);
}
// the low word of v >> sh for 0 <= sh <= 31: one funnel shift
__device__ __forceinline__ int shr_lo(long long v, int sh) {
    return (int)__funnelshift_r((unsigned)v,
                                (unsigned)((unsigned long long)v >> 32), sh);
}
// int32 -> double, exact: the bits of 2^52 + 2^31 + x, less 2^52 + 2^31
__device__ __forceinline__ double i2d(int x) {
    return __hiloint2double(0x43300000, x ^ 0x80000000) - 4503601774854144.0;
}
// double -> int64 for an integer |d| < 2^51, exact: d + 1.5 * 2^52 lies in
// [2^52, 2^53), where the mantissa holds 2^51 + d
__device__ __forceinline__ long long d2ll(double d) {
    return __double_as_longlong(d + 6755399441055744.0) -
           0x4338000000000000LL;
}
// ---- end of PTX helpers ----

// residual r (int32) << sh as int64, for 0 <= sh <= 31
__device__ __forceinline__ long long fold(int r, int sh) {
    return (long long)((unsigned long long)(long long)r << sh);
}

// The R residuals of a round from a ring row, as the sample type (int16
// sign-extends, int64 truncates to int32 for narrow batches, as .to()
// does).  16-byte reads: the row and u0 * rb are 16-byte aligned.
template <int R, typename XT>
__device__ __forceinline__ void load_round(XT (&r)[R],
                                           const unsigned char* row, int rb,
                                           int u0) {
    const uint4* p = (const uint4*)(row + u0 * rb);
    if (rb == 2) {
#pragma unroll
        for (int k = 0; k < R / 8; ++k) {
            const uint4 v = p[k];
            const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                r[8 * k + 2 * i] = (XT)(short)(w[i] & 0xFFFFu);
                r[8 * k + 2 * i + 1] = (XT)(short)(w[i] >> 16);
            }
        }
    } else if (rb == 4) {
#pragma unroll
        for (int k = 0; k < R / 4; ++k) {
            const uint4 v = p[k];
            r[4 * k] = (XT)(int)v.x;
            r[4 * k + 1] = (XT)(int)v.y;
            r[4 * k + 2] = (XT)(int)v.z;
            r[4 * k + 3] = (XT)(int)v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < R / 2; ++k) {
            const uint4 v = p[k];
            r[2 * k] = (XT)(long long)(((unsigned long long)v.y << 32) | v.x);
            r[2 * k + 1] =
                (XT)(long long)(((unsigned long long)v.w << 32) | v.z);
        }
    }
}

// x of sample u0 + u (int32, or int64 wide) into the x ring row `xrow`
// once a 16-byte group is full: group g at slot g ^ (row & 7).  u0 is a
// multiple of the group and u a constant of the unrolled round, so `out`
// stays in registers.
template <typename XT>
__device__ __forceinline__ void put_x(XT (&out)[16 / sizeof(XT)], XT x,
                                      unsigned char* xrow, int swz, int u0,
                                      int u) {
    constexpr int PER16 = 16 / (int)sizeof(XT);
    out[u % PER16] = x;
    if (u % PER16 != PER16 - 1) return;
    uint4 v;
    if (sizeof(XT) == 8) {
        const unsigned long long a = (unsigned long long)out[0];
        const unsigned long long b = (unsigned long long)out[1 % PER16];
        v = make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b,
                       (unsigned)(b >> 32));
    } else {
        v = make_uint4((unsigned)out[0], (unsigned)out[1 % PER16],
                       (unsigned)out[2 % PER16], (unsigned)out[3 % PER16]);
    }
    *(uint4*)(xrow + ((((u0 + u) / PER16) ^ swz) << 4)) = v;
}

// One round of R samples of one subframe in the generic form, from sample
// n0 (a multiple of R, so sample n0 + u's accumulator is P[u % MO]): P
// (wrapping int64) collects every tap, x = r + (P >> sh_eff).  WARM: the
// samples before the order pass through.
template <int MO, bool WIDE, bool WARM>
__device__ __forceinline__ void run_round(
    long long (&P)[MO], const int (&q)[MO],
    const typename std::conditional<WIDE, long long, int>::type (&r)[
        round_len<MO>()],
    unsigned char* xrow, int swz, int u0, int n0, int ord, int sh_eff) {
    using XT = typename std::conditional<WIDE, long long, int>::type;
    using UT = typename std::make_unsigned<XT>::type;
    constexpr int R = round_len<MO>();
    XT out[16 / sizeof(XT)];
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int slot = u % MO;
        const XT p = (XT)(P[slot] >> sh_eff);
        XT x = (XT)((UT)r[u] + (UT)p);
        if (WARM && n0 + u < ord) x = r[u];
        P[slot] = 0;                            // born for sample n + MO
        // the chain's multiply-add first: P[n+1] += q[0] * x[n]
#pragma unroll
        for (int j = 0; j < MO; ++j) {
            long long& a = P[(u + 1 + j) % MO];
            if (WIDE)
                a = (long long)((unsigned long long)a +
                                (unsigned long long)(long long)q[j] *
                                    (unsigned long long)x);
            else
                a = mad_wide(q[j], (int)x, a);
        }
        put_x<XT>(out, x, xrow, swz, u0, u);
    }
}

// One round of the folded form (narrow; taps of 16 signed bits, shifts
// 0..31): x[n] is the low word of V >> sh, one funnel shift, where
// V = C + q[0] * x[n-1] is the chain's one multiply-add and
// C = sum_{j>=1} q[j] x[n-j-1] + (r[n] << sh) was made off the chain.  The
// older taps' sums D (sample n's in D[n % MO]) are doubles: each product
// is below 2^46 and each sum below 2^51, so every fused multiply-add is
// exact, and they run on the FP64 pipe, beside the chain's integer one.
// C for sample n + 2 is taken from D as soon as its last term is in; the
// residuals of a round's first two samples join at the round's start.
template <int MO>
__device__ __forceinline__ void run_folded(double (&D)[MO], long long& V,
                                           long long& C, int q0,
                                           const double (&qd)[MO],
                                           const int (&r)[round_len<MO>()],
                                           unsigned char* xrow, int swz,
                                           int u0, int sh) {
    constexpr int R = round_len<MO>();
    int out[4];
    V += fold(r[0], sh);
    C += fold(r[1], sh);
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int x = shr_lo(V, sh);
        V = mad_cc(q0, x, C);                   // the chain
        const long long rs = u + 2 < R ? fold(r[u + 2 < R ? u + 2 : 0], sh)
                                       : 0;
        if (MO > 1) {
            const double xd = i2d(x);
#pragma unroll
            for (int j = 1; j < MO; ++j) {
                double& d = D[(u + 1 + j) % MO];
                d = j == MO - 1 ? qd[j] * xd : fma(qd[j], xd, d);
            }
            C = d2ll(D[(u + 2) % MO]) + rs;
        } else {
            C = rs;
        }
        put_x<int>(out, x, xrow, swz, u0, u);
    }
}

struct Args {
    const unsigned char* res;   // row s at res + s * rstride * rb
    int rb;                     // residual bytes: 2, 4 or 8
    long long rstride;          // elements
    bool bulk;                  // rows 16-byte aligned: bulk copies
    const int* order;
    const int* shift;
    const int* qlp;             // [S, MO]
    const int* wasted;
    const int* asg;
    unsigned char* pcm;         // [S, N] of int16 (out16) or the sample type
    bool out16;
    bool vec_out;               // pcm rows 16-byte aligned
    unsigned char* oor;
    int S, N, C, bps;
};

// warp 1: the residual rows of the CTA's subframes, chunk by chunk, into
// the ring
__device__ __forceinline__ void produce(const Args& a, unsigned char* ring,
                                        uint32_t full, uint32_t empty,
                                        int s0, int lane) {
    const int rb = a.rb;
    const int pitch = in_pitch(rb);
    const int live = min(SUBS, a.S - s0);
    const int nch = (a.N + K - 1) / K;
    for (int c = 0; c < nch; ++c) {
        const int st = c % IN_STAGES;
        bar_wait(empty + 8 * st, ((c / IN_STAGES) & 1) ^ 1);
        const int n0 = c * K;
        const int len = min(K, a.N - n0);
        unsigned char* stage = ring + st * in_stage_bytes(rb);
        if (a.bulk && (len * rb) % 16 == 0) {
            if (lane == 0) bar_arrive_tx(full + 8 * st, live * len * rb);
            __syncwarp();
            if (lane < live)
                bulk_copy(smem_addr(stage + lane * pitch),
                          a.res + ((size_t)(s0 + lane) * a.rstride + n0) * rb,
                          len * rb, full + 8 * st);
            if (lane != 0) bar_arrive(full + 8 * st);
            continue;
        }
        // plain loads, the lanes along the samples of one row at a time
        for (int row = 0; row < live; ++row) {
            const unsigned char* src =
                a.res + ((size_t)(s0 + row) * a.rstride + n0) * rb;
            unsigned char* dst = stage + row * pitch;
            for (int e = lane; e < len; e += 32) {
                if (rb == 2)
                    ((short*)dst)[e] = __ldg((const short*)src + e);
                else if (rb == 4)
                    ((int*)dst)[e] = __ldg((const int*)src + e);
                else
                    ((long long*)dst)[e] = __ldg((const long long*)src + e);
            }
        }
        bar_arrive(full + 8 * st);
    }
}

// warp 0: the recursion, a lane a subframe
template <int MO, bool WIDE>
__device__ __forceinline__ void recurse(const Args& a,
                                        const unsigned char* in_ring,
                                        unsigned char* x_ring,
                                        uint32_t bars, int s0, int lane) {
    using XT = typename std::conditional<WIDE, long long, int>::type;
    constexpr int R = round_len<MO>();
    const uint32_t full_in = bars, empty_in = bars + 8 * IN_STAGES;
    const uint32_t full_out = bars + 16 * IN_STAGES;
    const uint32_t empty_out = full_out + 8 * OUT_STAGES;
    const int s = s0 + lane;
    const bool live = s < a.S;
    const int ord = live ? a.order[s] : 0;
    const int sh = live ? a.shift[s] : 0;
    int q[MO];
    long long P[MO];
    bool small = true;
#pragma unroll
    for (int i = 0; i < MO; ++i) {
        q[i] = live ? a.qlp[(size_t)s * MO + i] : 0;
        P[i] = 0;
        small &= q[i] >= -32768 && q[i] <= 32767;
    }
    // PyTorch's >>: a shift below 0 or at 64 or more gives the sign
    const int sh_eff = (sh < 0 || sh >= 64) ? 63 : sh;
    // the folded form is exact for taps of 16 signed bits and shifts 0..31;
    // the warp takes it only when all its subframes qualify
    const bool folded =
        !WIDE && __all_sync(FULL, small && sh >= 0 && sh <= 31);
    const int rb = a.rb;
    const unsigned char* in_row = in_ring + lane * in_pitch(rb);
    unsigned char* x_row = x_ring + lane * K * (int)sizeof(XT);
    const int swz = lane & 7;
    const int nch = (a.N + K - 1) / K;
    // the rounds walk the chunks: chunk c's residual and x stages are held
    // from its first round to its last
    int c = 0, u0 = 0;
    const unsigned char* src = in_row;
    unsigned char* dst = x_row;
    auto acquire = [&]() {
        const int ist = c % IN_STAGES, ost = c % OUT_STAGES;
        bar_wait(full_in + 8 * ist, (c / IN_STAGES) & 1);
        bar_wait(empty_out + 8 * ost, ((c / OUT_STAGES) & 1) ^ 1);
        src = in_row + ist * in_stage_bytes(rb);
        dst = x_row + ost * out_stage_bytes(sizeof(XT));
    };
    auto advance = [&]() {
        u0 += R;
        if (u0 < min(K, a.N - c * K)) return;
        bar_arrive(empty_in + 8 * (c % IN_STAGES));
        bar_arrive(full_out + 8 * (c % OUT_STAGES));
        ++c;
        u0 = 0;
        if (c < nch) acquire();
    };
    XT r[R];
    auto load = [&]() { load_round<R, XT>(r, src, rb, u0); };
    acquire();
    // the generic form: every round of a warp that does not fold, and the
    // warm-up rounds (a sample before its subframe's order passes through)
    while (c < nch) {
        const int n0 = c * K + u0;
        const bool warm = __any_sync(FULL, ord > n0);
        if (folded && !warm) break;
        load();
        if (warm)
            run_round<MO, WIDE, true>(P, q, r, dst, swz, u0, n0, ord, sh_eff);
        else
            run_round<MO, WIDE, false>(P, q, r, dst, swz, u0, n0, ord,
                                       sh_eff);
        advance();
    }
    if constexpr (!WIDE) {
        if (c >= nch) return;
        // the folded form from here on: sample n0's sum is complete in
        // P[0], sample n0 + 1's holds every tap but the newest, the others
        // go to D
        long long V = P[0], C = MO > 1 ? P[1 % MO] : 0;
        double D[MO], qd[MO];
#pragma unroll
        for (int i = 0; i < MO; ++i) {
            D[i] = i >= 2 ? (double)P[i] : 0.0;
            qd[i] = (double)q[i];
        }
        while (c < nch) {
            load();
            run_folded<MO>(D, V, C, q[0], qd, r, dst, swz, u0, sh);
            advance();
        }
    }
}

// the output of `n` samples of the sample type from sample n0 of a pcm row,
// narrowed to int16 with out16; one 4- to 16-byte store when `vec`
template <typename XT, int PER16>
__device__ __forceinline__ void store_group(const XT (&y)[PER16],
                                            unsigned char* row, bool out16,
                                            int n0, int n, bool vec) {
    if (out16) {
        if (vec && PER16 == 4) {
            *(uint2*)(row + n0 * 2) = make_uint2(
                ((unsigned)y[0] & 0xFFFFu) | ((unsigned)y[1 % PER16] << 16),
                ((unsigned)y[2 % PER16] & 0xFFFFu) |
                    ((unsigned)y[3 % PER16] << 16));
            return;
        }
        if (vec && PER16 == 2) {
            *(unsigned*)(row + n0 * 2) =
                ((unsigned)y[0] & 0xFFFFu) | ((unsigned)y[1] << 16);
            return;
        }
#pragma unroll
        for (int i = 0; i < PER16; ++i)
            if (i < n) ((short*)row)[n0 + i] = (short)y[i];
        return;
    }
    if (vec) {
        uint4 v;
        if (sizeof(XT) == 8) {
            const unsigned long long a = (unsigned long long)y[0];
            const unsigned long long b = (unsigned long long)y[1 % PER16];
            v = make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b,
                           (unsigned)(b >> 32));
        } else {
            v = make_uint4((unsigned)y[0], (unsigned)y[1 % PER16],
                           (unsigned)y[2 % PER16], (unsigned)y[3 % PER16]);
        }
        *(uint4*)(row + n0 * (int)sizeof(XT)) = v;
        return;
    }
#pragma unroll
    for (int i = 0; i < PER16; ++i)
        if (i < n) ((XT*)row)[n0 + i] = y[i];
}

// warps 2..: the epilogue.  Each group of 8 lanes takes one slot (a
// stereo frame's two rows when C == 2, else one row) and reads its rows'
// 16-byte groups g = part + 8 k, so the 8 lanes read 8 different banks.
template <bool WIDE>
__device__ __forceinline__ void drain(const Args& a,
                                      const unsigned char* x_ring,
                                      uint32_t full_out, uint32_t empty_out,
                                      int s0, int e, int lane) {
    using XT = typename std::conditional<WIDE, long long, int>::type;
    using UT = typename std::make_unsigned<XT>::type;
    constexpr int XB = (int)sizeof(XT);
    constexpr int PER16 = 16 / XB;
    constexpr int GROUPS = K / PER16;               // 16-byte groups a row
    constexpr int BITS = 8 * XB;
    const bool stereo = a.C == 2;
    const int ROWS = stereo ? 2 : 1;                // rows a slot
    const int slots = stereo ? SUBS / 2 : SUBS;
    const int part = lane & 7;
    const int first = e * 4 + (lane >> 3);          // + 8 * pass
    const int passes = slots / (4 * EPI_WARPS);     // 2 (stereo) or 4
    const unsigned check = (a.bps > 0 && (WIDE || a.bps < 32)) ? 1u : 0u;
    const XT lim = check ? (XT)(1LL << (a.bps - 1)) : (XT)0;
    unsigned bad[4] = {0, 0, 0, 0};
    const int nch = (a.N + K - 1) / K;
    for (int c = 0; c < nch; ++c) {
        const int ost = c % OUT_STAGES;
        bar_wait(full_out + 8 * ost, (c / OUT_STAGES) & 1);
        const unsigned char* stage = x_ring + ost * out_stage_bytes(XB);
        const int n0 = c * K;
#pragma unroll
        for (int pass = 0; pass < 4; ++pass) {
            if (pass >= passes) break;
            const int slot = first + 8 * pass;
            const int row0 = slot * ROWS;               // CTA row
            if (s0 + row0 >= a.S) continue;
            const int s = s0 + row0;
            int w[2], asg = 0;
#pragma unroll
            for (int k = 0; k < 2; ++k)
                w[k] = (k < ROWS) ? a.wasted[s + k] : 0;
            if (stereo) asg = a.asg[s >> 1];
#pragma unroll
            for (int k = 0; k < GROUPS / 8; ++k) {
                const int g = part + 8 * k;
                const int n = n0 + g * PER16;           // first sample
                if (n >= a.N) break;
                XT y[2][PER16];
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    if (rr >= ROWS) break;
                    const int row = row0 + rr;
                    const uint4 v = *(const uint4*)(
                        stage + row * K * XB + ((g ^ (row & 7)) << 4));
                    XT x[PER16];
                    if (WIDE) {
                        x[0] = (XT)(long long)(
                            ((unsigned long long)v.y << 32) | v.x);
                        x[1 % PER16] = (XT)(long long)(
                            ((unsigned long long)v.w << 32) | v.z);
                    } else {
                        x[0] = (XT)(int)v.x;
                        x[1 % PER16] = (XT)(int)v.y;
                        x[2 % PER16] = (XT)(int)v.z;
                        x[3 % PER16] = (XT)(int)v.w;
                    }
                    // PyTorch's <<: below 0 or at the width or more gives 0
                    const int we = w[rr] & (BITS - 1);
                    const UT wm =
                        (w[rr] < 0 || w[rr] >= BITS) ? (UT)0 : ~(UT)0;
#pragma unroll
                    for (int i = 0; i < PER16; ++i)
                        y[rr][i] = (XT)(((UT)x[i] << we) & wm);
                }
                if (stereo) {
#pragma unroll
                    for (int i = 0; i < PER16; ++i) {
                        const XT A = y[0][i], B = y[1][i];
                        const UT mid = ((UT)A << 1) | ((UT)B & 1);
                        y[0][i] = asg == ASG_RIGHT_SIDE ? (XT)((UT)B + (UT)A)
                                  : asg == ASG_MID_SIDE ? (XT)(mid + (UT)B) >> 1
                                                        : A;
                        y[1][i] = asg == ASG_LEFT_SIDE ? (XT)((UT)A - (UT)B)
                                  : asg == ASG_MID_SIDE ? (XT)(mid - (UT)B) >> 1
                                                        : B;
                    }
                }
                const int left = a.N - n;               // samples in range
                const bool vec = a.vec_out && left >= PER16;
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    if (rr >= ROWS) break;
#pragma unroll
                    for (int i = 0; i < PER16; ++i)
                        bad[pass] |= ((unsigned)(y[rr][i] < -lim) |
                                      (unsigned)(y[rr][i] >= lim)) &
                                     check & (unsigned)(i < left);
                    unsigned char* orow =
                        a.pcm + (size_t)(s + rr) * a.N * (a.out16 ? 2 : XB);
                    store_group<XT, PER16>(y[rr], orow, a.out16, n, left,
                                           vec);
                }
            }
        }
        bar_arrive(empty_out + 8 * ost);
    }
    // one store of 1 a flagged slot: a ballot over its 8 lanes
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
        if (pass >= passes) break;
        const unsigned votes = __ballot_sync(FULL, bad[pass] != 0);
        const int row0 = (first + 8 * pass) * ROWS;
        if (part == 0 && ((votes >> (lane & ~7)) & 0xFFu) &&
            s0 + row0 < a.S)
            a.oor[(s0 + row0) / a.C] = 1;
    }
}

template <int MO, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1) restore_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t bars = smem_addr(smem);
    unsigned char* in_ring = smem + BARS_BYTES;
    unsigned char* x_ring = in_ring + IN_STAGES * in_stage_bytes(a.rb);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s0 = blockIdx.x * SUBS;
    // full_in, empty_in [IN_STAGES], full_out, empty_out [OUT_STAGES]:
    // every thread of the arriving role arrives
    if (threadIdx.x == 0) {
        for (int i = 0; i < IN_STAGES; ++i) {
            bar_init(bars + 8 * i, 32);                         // producer
            bar_init(bars + 8 * (IN_STAGES + i), 32);           // recursion
        }
        for (int i = 0; i < OUT_STAGES; ++i) {
            bar_init(bars + 8 * (2 * IN_STAGES + i), 32);       // recursion
            bar_init(bars + 8 * (2 * IN_STAGES + OUT_STAGES + i),
                     32 * EPI_WARPS);                           // epilogue
        }
        bar_init_fence();
    }
    __syncthreads();
    if (warp == 0) {
        recurse<MO, WIDE>(a, in_ring, x_ring, bars, s0, lane);
    } else if (warp == 1) {
        produce(a, in_ring, bars, bars + 8 * IN_STAGES, s0, lane);
    } else {
        const uint32_t full_out = bars + 16 * IN_STAGES;
        drain<WIDE>(a, x_ring, full_out, full_out + 8 * OUT_STAGES, s0,
                    warp - 2, lane);
    }
}

template <int MO, bool WIDE>
cudaError_t launch(const Args& a, cudaStream_t st) {
    const int smem = smem_bytes(a.rb, WIDE ? 8 : 4);
    cudaError_t e = cudaFuncSetAttribute(
        restore_kernel<MO, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    const int blocks = (a.S + SUBS - 1) / SUBS;
    restore_kernel<MO, WIDE><<<blocks, THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_mo(int mo, const Args& a, cudaStream_t st) {
    switch (mo) {
        case 1: return launch<1, WIDE>(a, st);
        case 2: return launch<2, WIDE>(a, st);
        case 4: return launch<4, WIDE>(a, st);
        case 8: return launch<8, WIDE>(a, st);
        case 12: return launch<12, WIDE>(a, st);
        case 16: return launch<16, WIDE>(a, st);
        case 32: return launch<32, WIDE>(a, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Restore S subframes of N samples each.  All pointers are device pointers:
// res rows of rstride elements of rbytes (2, 4 or 8) bytes, order/shift/
// wasted [S] int32, qlp [S, mo] int32 contiguous (mo one of 1, 2, 4, 8,
// 12, 16, 32), asg [S / C] int32 (read only when C == 2), pcm [S, N]
// contiguous (int16 when out16, else int32, int64 when wide), oor [S / C]
// bool, zeroed by the caller.  vec_in: res and its rows are 16-byte aligned
// (bulk copies); vec_out: pcm and its rows are 16-byte aligned (vector
// stores).  Returns the CUDA error code of the launch (0 on success).
int flac_restore(const void* res, int rbytes, long long rstride, int vec_in,
                 const void* order, const void* shift, const void* qlp,
                 int mo, const void* wasted, const void* asg, void* pcm,
                 int out16, int vec_out, void* oor, int S, int N, int C,
                 int wide, int bps, void* stream) {
    if (S <= 0 || N <= 0) return 0;
    if ((rbytes != 2 && rbytes != 4 && rbytes != 8) || rstride < N ||
        C <= 0 || S % C || bps < 0 || bps > 32)
        return (int)cudaErrorInvalidValue;
    const Args a = {(const unsigned char*)res, rbytes, rstride, vec_in != 0,
                    (const int*)order, (const int*)shift, (const int*)qlp,
                    (const int*)wasted, (const int*)asg,
                    (unsigned char*)pcm, out16 != 0, vec_out != 0,
                    (unsigned char*)oor, S, N, C, bps};
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(wide ? launch_mo<true>(mo, a, st)
                      : launch_mo<false>(mo, a, st));
}

// Bytes of dynamic shared memory a launch takes for residuals of rbytes
// bytes (the host mirror is ops/restore_cuda.py smem_bytes).
int flac_restore_smem(int rbytes, int wide) {
    return smem_bytes(rbytes, wide ? 8 : 4);
}

}  // extern "C"
