// The encoder's LPC coefficient stage (kernel K6 of flac_tpu_torch).
//
// Replaces flac_tpu/ops/lpc.py levinson_all_orders (:149),
// estimate_best_order (:205) and quantize_coefficients (:257), with the
// candidate grid of flac_tpu/models/subframe.py:155-218 (-e, -p, the
// precision clamp), which XLA fuses into the jitted encode_batch on the TPU
// and the port ran as some 900 small torch kernels a -5 batch.  Same
// contract as flac_tpu_torch/models/subframe.py lpc_candidates_plain, its
// plain version, bit for bit: from the autocorrelations autoc[r, a, 0..O]
// (float64) of every (frame and channel candidate r, apodization a) and
// the subframe's bps, each candidate's quantized coefficients qc[32],
// shift, order, precision and ok flag (the order's validity, the "don't
// even try" estimate and the quantizer's own check).
//
// Exactness: every float64 step that the plain version rounds on its own
// is one intrinsic here (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn,
// __drcp_rn), so nvcc contracts nothing into an FMA; Levinson's inner sum
// runs one product at a time from j = 0, as the plain version restates it;
// log2 is the CUDA math library's log2(double), the function behind
// torch's float64 log2 on the card; 2^e is built from its bits (0 below
// 2^-1074, inf from 2^1024); casts are the C++ casts torch's kernels use;
// integer steps that could overflow wrap as torch's int32 arithmetic does;
// ties in the order guess go to the first index.
//
// Design (Hopper): a group of G lanes a (r, a) problem, G = lanes_for(O),
// a CTA of one warp (so a -5 batch's 256 problems of order 8 take 64 CTAs
// on 64 SMs).  Every lane of a group runs the one Levinson recursion, fully
// unrolled through a template on the order (6, 8 and 12, the presets'; 32
// for every other order, with the steps past O skipped), so the state
// lives in registers and the group's lanes cost nothing more in SIMT; the
// autocorrelations sit in shared memory.  Lane i % G owns order i + 1: at
// step i it keeps that order's error, "dead" flag and float32
// coefficients in its registers (selects, so the group does not diverge),
// and no order's coefficients are computed twice.  Without -e each lane
// estimates its own orders (the O log2 calls side by side), a butterfly of
// shuffles takes the first-index argmin, and the guessed order's
// coefficients go from their owner to the group a shuffle each; with -e
// each lane quantizes its own orders.  The candidates' precisions (-p) are shared
// out over the lanes, each quantizer stops at its order (the tail is the
// clamp of 0, as the plain version writes it), and each qc row goes out as
// eight 16-byte stores.  At -5 a batch is 256 problems of order 8, at -8
// 2304 of order 12, ~50 KB of data in all: the bound is the chain of
// dependent float64 operations of one problem (the recursion, an estimate,
// a quantizer) and the launch, not bytes.  flac_lpc_op_probe measures the
// dependent latency of each kind of operation on that chain, from which
// chip_smoke.py states the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ORDER = 32;          // format.MAX_LPC_ORDER
constexpr int MIN_PREC = 5;            // format.MIN_QLP_COEFF_PRECISION
constexpr int MAX_PREC = 15;           // format.MAX_QLP_COEFF_PRECISION
constexpr int N_PREC = MAX_PREC - MIN_PREC + 1;
constexpr int MAX_SHIFT = 15;
constexpr int MIN_SHIFT = -16;
constexpr int CTA = 32;                // threads a CTA: one warp
constexpr unsigned FULL = 0xFFFFFFFFu;

// lanes a problem for a template order (ops/lpc_cuda.py lanes mirrors it)
__host__ __device__ constexpr int lanes_for(int ot) {
    return ot <= 8 ? 8 : ot <= 16 ? 16 : 32;
}

// int32 arithmetic that wraps, as torch's does on the card
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// exact 2.0**e (ops/lpc.py _pow2: the table of 2^-1075 .. 2^1024)
__device__ __forceinline__ double pow2(int e) {
    if (e <= -1075) return 0.0;
    if (e >= 1024) return __longlong_as_double(0x7FF0000000000000LL);
    if (e >= -1022) return __longlong_as_double((long long)(e + 1023) << 52);
    return __longlong_as_double(1LL << (e + 1074));
}

// floor(log2(v)) for v in 1..32 (bitmath.c:63, ops/lpc.py ilog2)
__device__ __forceinline__ int ilog2(int v) {
    return (v > 1) + (v > 3) + (v > 7) + (v > 15) + (v > 31);
}

// estimate_best_order's est_bps for one error (selects, no branch: the
// log2 of 1 where it is not used, so that two estimates can overlap)
__device__ __forceinline__ double est_bps(double err, double scale) {
    const double b =
        __dmul_rn(0.5, log2(err > 0.0 ? __dmul_rn(err, scale) : 1.0));
    return err > 0.0 ? (b < 0.0 ? 0.0 : b) : (err < 0.0 ? 1e32 : 0.0);
}

// the larger of two |c| with NaN sticking, as the plain version's max
__device__ __forceinline__ double nanmax(double x, double y) {
    return (y > x || y != y) ? y : x;
}

struct Args {
    const double* autoc;
    const int* bps;
    int* qc;
    int* qshift;
    int* order;
    int* prec;
    unsigned char* ok;
    int R, A, O, N, exhaustive, prec_search, static_prec;
    int vec;                           // qc is 16-byte aligned
};

// quantize_coefficients for one candidate: cs[] its float32 coefficients
// (`order` of them, order <= OT); writes qc[32] and the candidate's shift,
// order, precision and ok flag at k
template <int OT>
__device__ __forceinline__ void quantize(const Args& a, long long k,
                                         const float (&cs)[OT], int order,
                                         int prec, bool cand_ok) {
    double c[OT];
#pragma unroll
    for (int j = 0; j < OT; ++j) c[j] = j < order ? (double)cs[j] : 0.0;
    // max |c| over the order as a tree (the zeros past it change nothing)
    double m[OT];
#pragma unroll
    for (int j = 0; j < OT; ++j) m[j] = fabs(c[j]);
#pragma unroll
    for (int w = 1; w < OT; w <<= 1)
#pragma unroll
        for (int j = 0; j + w < OT; j += 2 * w) m[j] = nanmax(m[j], m[j + w]);
    const double cmax = nanmax(0.0, m[0]);
    bool valid = cmax > 0.0;
    const double safe = valid ? cmax : 1.0;
    // floor(log2(safe)), repaired at the powers of two as the plain
    // version does; for a finite safe (a float's |c| as a double: normal,
    // or 1.0) the repaired value is its exponent, read from its bits
    const int ebits = (int)((__double_as_longlong(safe) >> 52) & 0x7FF);
    int log2cmax = ebits - 1023;
    if (ebits == 0x7FF) {
        int e0 = (int)floor(log2(safe));
        if (pow2(e0) > safe) e0 = wsub(e0, 1);
        log2cmax = pow2(wadd(e0, 1)) <= safe ? wadd(e0, 1) : e0;
    }
    int shift = wsub(wsub(wsub(prec, 1), log2cmax), 1);
    shift = shift < MAX_SHIFT ? shift : MAX_SHIFT;
    valid = valid && shift >= MIN_SHIFT;
    const double scale = pow2(shift);
    // 1 << (prec - 1) in int32 with torch's rule: 0 for a shift out of
    // [0, 32)
    const int sb = prec - 1;
    const int top = (sb < 0 || sb >= 32) ? 0 : (int)(1u << sb);
    const double qmax = (double)wsub(top, 1);
    const double qmin = -__dadd_rn(qmax, 1.0);
    // past the order the plain version's q is 0 clamped to [qmin, qmax]:
    // 0 for every precision of the grid (5..15), -1 where top is 0
    double qt = 0.0;
    qt = qt < qmin ? qmin : qt;
    qt = qt > qmax ? qmax : qt;
    const int tail = (int)qt;
    int q[OT];
    double error = 0.0;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
        q[j] = tail;
        if (j < order) {
            const double e = __dadd_rn(error, __dmul_rn(c[j], scale));
            // sign(e) * floor(|e| + 0.5) as the plain version rounds it;
            // copysign differs from the sign's product only in the sign of
            // a zero (e = -0), which no integer output or later nonzero
            // error sees
            double v = copysign(floor(__dadd_rn(fabs(e), 0.5)), e);
            v = v < qmin ? qmin : v;        // torch.maximum, then minimum
            v = v > qmax ? qmax : v;
            error = __dsub_rn(e, v);
            q[j] = (int)v;
        }
    }
    int* row = a.qc + k * MAX_ORDER;
    if (a.vec) {
        int4* row4 = reinterpret_cast<int4*>(row);
#pragma unroll
        for (int v = 0; v < MAX_ORDER / 4; ++v) {
            int x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = 4 * v + u;
                x[u] = j < OT ? q[j < OT ? j : 0] : tail;
            }
            row4[v] = make_int4(x[0], x[1], x[2], x[3]);
        }
    } else {
#pragma unroll
        for (int j = 0; j < MAX_ORDER; ++j)
            row[j] = j < OT ? q[j < OT ? j : 0] : tail;
    }
    a.qshift[k] = shift > 0 ? shift : 0;
    a.order[k] = order;
    a.prec[k] = prec;
    a.ok[k] = (unsigned char)(cand_ok && valid);
}

// precision p of a candidate's grid (-p: 5 + p, else the static one), and
// whether the grid allows it
__device__ __forceinline__ int precision(const Args& a, int order, int bps,
                                         int p, bool& ok_p) {
    const int v = wsub(wsub(32, bps), ilog2(order));
    if (a.prec_search) {
        const int clamp = bps <= 17 ? (v > MIN_PREC ? v : MIN_PREC)
                                    : MAX_PREC;
        ok_p = MIN_PREC + p <= clamp;
        return MIN_PREC + p;
    }
    ok_p = true;
    return bps <= 17 ? (v < a.static_prec ? v : a.static_prec)
                     : a.static_prec;
}

template <int OT>
__global__ void __launch_bounds__(CTA) lpc_coeffs_kernel(const Args a) {
    constexpr int G = lanes_for(OT);
    constexpr int PPC = CTA / G;                    // problems a CTA
    constexpr int NS = (OT + G - 1) / G;            // orders a lane
    __shared__ double s_ac[PPC][OT + 1];
    const int gl = threadIdx.x % G, slot = threadIdx.x / G;
    const long long prob = (long long)blockIdx.x * PPC + slot;
    const bool live = prob < (long long)a.R * a.A;
    const int O = a.O;
    const int r = live ? (int)(prob / a.A) : 0;
    // the autocorrelations into shared memory, the group's lanes side by
    // side
    for (int l = gl; l <= O; l += G)
        s_ac[slot][l] = live ? a.autoc[prob * (O + 1) + l] : 0.0;
    const int bps = live ? a.bps[r] : 0;
    __syncwarp();
    const double* ac = s_ac[slot];

    // the recursion, once: lane i % G keeps order i + 1's error, dead flag
    // (before the step) and float32 coefficients
    double lpc[OT];
#pragma unroll
    for (int j = 0; j < OT; ++j) lpc[j] = 0.0;
    double err = ac[0];
    bool dead = err == 0.0;
    double err_own[NS];
    bool dead_own[NS];
    float own[NS][OT];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        err_own[s] = 0.0;
        dead_own[s] = true;
#pragma unroll
        for (int j = 0; j < OT; ++j) own[s][j] = 0.0f;
    }
    // unrolled: the recursion's state stays in registers
#pragma unroll
    for (int i = 0; i < OT; ++i) {
        if (i >= O) continue;
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < i; ++j)
            s = __dadd_rn(s, __dmul_rn(lpc[j], ac[i - j]));
        const double safe = err == 0.0 ? 1.0 : err;
        const double rr = __ddiv_rn(-__dadd_rn(ac[i + 1], s), safe);
        // lpc'[j] = lpc[j] + r * lpc[i-1-j] for j < i (from the old values)
#pragma unroll
        for (int j = 0; j < i / 2; ++j) {
            const double x = lpc[j], y = lpc[i - 1 - j];
            lpc[j] = __dadd_rn(x, __dmul_rn(rr, y));
            lpc[i - 1 - j] = __dadd_rn(y, __dmul_rn(rr, x));
        }
        if (i & 1) {
            const int mid = (i - 1) >> 1;
            lpc[mid] = __dadd_rn(lpc[mid], __dmul_rn(rr, lpc[mid]));
        }
        lpc[i] = rr;
        err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(rr, rr)));
        // selects, not a branch: the group's lanes do not diverge
        const bool mine = gl == i % G;
        err_own[i / G] = mine ? err : err_own[i / G];
        dead_own[i / G] = mine ? dead : dead_own[i / G];
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            // the plain version's (-lpc).to(float32), 0 for a dead order
            const float c = dead ? 0.0f : (float)(-lpc[j]);
            own[i / G][j] = mine ? c : own[i / G][j];
        }
        dead = dead || err == 0.0;
    }
    const double bpsd = (double)bps;
    const int nP = a.prec_search ? N_PREC : 1;

    if (a.exhaustive) {
        // every order a candidate, quantized by its owner at every
        // precision; its own estimate at scale 0.5 / (N - order)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int i = gl + s * G;
            if (i >= O || !live) continue;
            const int order = i + 1;
            const double scale =
                __dmul_rn(__drcp_rn((double)(a.N - order)), 0.5);
            const bool ok = !dead_own[s] && est_bps(err_own[s], scale) < bpsd;
            const long long cand = prob * O + i;
            for (int p = 0; p < nP; ++p) {
                bool ok_p;
                const int prec = precision(a, order, bps, p, ok_p);
                quantize<OT>(a, cand * nP + p, own[s], order, prec,
                             ok && ok_p);
            }
        }
        return;
    }

    // the guess: each lane scores its orders, then the first-index argmin
    // over the group (bits never NaN: est_bps gives 0 for a NaN error)
    const double scale_n = __ddiv_rn(0.5, (double)a.N);
    const double ovh = (double)wadd(bps, a.static_prec);
    double best_bits = __longlong_as_double(0x7FF0000000000000LL);
    int best = (1 << 30) | 0;                        // (index << 1) | ok
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const int i = gl + s * G;
        if (i >= O) continue;
        const int order = i + 1;
        const double o = (double)order;
        const double bits = __dadd_rn(
            __dmul_rn(est_bps(err_own[s], scale_n), (double)a.N - o),
            __dmul_rn(o, ovh));
        const double scale =
            __dmul_rn(__drcp_rn((double)(a.N - order)), 0.5);
        const bool ok = !dead_own[s] && est_bps(err_own[s], scale) < bpsd;
        if (s == 0 || bits < best_bits) {
            best_bits = bits;
            best = (i << 1) | (int)ok;
        }
    }
#pragma unroll
    for (int w = 1; w < G; w <<= 1) {
        const double ob = __shfl_xor_sync(FULL, best_bits, w, G);
        const int oi = __shfl_xor_sync(FULL, best, w, G);
        if (ob < best_bits || (ob == best_bits && oi < best)) {
            best_bits = ob;
            best = oi;
        }
    }
    const int order = (best >> 1) + 1;
    const bool ok = best & 1;
    // the guessed order's coefficients from its owner, a shuffle each
    float cs[OT];
    const int owner = (order - 1) % G, s_own = (order - 1) / G;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
        float v = own[0][j];
#pragma unroll
        for (int s = 1; s < NS; ++s) v = s == s_own ? own[s][j] : v;
        cs[j] = __shfl_sync(FULL, v, owner, G);
    }
    if (!live) return;
    for (int p = gl; p < nP; p += G) {
        bool ok_p;
        const int prec = precision(a, order, bps, p, ok_p);
        quantize<OT>(a, prob * nP + p, cs, order, prec, ok && ok_p);
    }
}

template <int OT>
int launch(const Args& a, cudaStream_t stream) {
    constexpr int PPC = CTA / lanes_for(OT);
    const long long problems = (long long)a.R * a.A;
    const long long ctas = (problems + PPC - 1) / PPC;
    lpc_coeffs_kernel<OT><<<(unsigned)ctas, CTA, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// the dependent latency of one kind of the chain's operations: one thread
// runs `steps` of them in a row (op 0 __dadd_rn; 1 __ddiv_rn; 2 log2 and
// an add; 3 floor and an add; 4 __dmul_rn) and writes the clock64 cycles
// they took
__global__ void lpc_op_probe_kernel(int op, double x, int steps,
                                    double* sink, long long* cycles) {
    double v = x;
    const long long t0 = clock64();
    switch (op) {
        case 0: for (int i = 0; i < steps; ++i) v = __dadd_rn(v, x); break;
        case 1: for (int i = 0; i < steps; ++i) v = __ddiv_rn(x, v); break;
        case 2: for (int i = 0; i < steps; ++i) v = __dadd_rn(log2(v), 2.0);
                break;
        case 3: for (int i = 0; i < steps; ++i)
                    v = __dadd_rn(floor(v), 0.75);
                break;
        default: for (int i = 0; i < steps; ++i) v = __dmul_rn(v, x);
    }
    const long long t1 = clock64();
    sink[0] = v;
    cycles[0] = t1 - t0;
}

}  // namespace

extern "C" {

// K6 on R = B * CH rows of A apodizations: autoc [R, A, O+1] float64,
// bps [R] int32; qc [R, AC, 32], qshift, order, prec [R, AC] int32 and
// ok [R, AC] bytes out (AC = A, times O with exhaustive, times 11 with
// prec_search), all device pointers.  Returns the CUDA error code of the
// launch (0 on success).
int flac_lpc_coeffs(const void* autoc, const void* bps, void* qc,
                    void* qshift, void* order, void* prec, void* ok, int R,
                    int A, int O, int N, int exhaustive, int prec_search,
                    int static_prec, void* stream) {
    if (R <= 0 || A <= 0) return 0;
    if (O < 1 || O > MAX_ORDER || N <= O) return (int)cudaErrorInvalidValue;
    Args a{(const double*)autoc, (const int*)bps, (int*)qc, (int*)qshift,
           (int*)order, (int*)prec, (unsigned char*)ok, R, A, O, N,
           exhaustive, prec_search, static_prec,
           (int)(((uintptr_t)qc & 15) == 0)};
    const cudaStream_t s = (cudaStream_t)stream;
    if (O <= 6) return launch<6>(a, s);
    if (O <= 8) return launch<8>(a, s);
    if (O <= 12) return launch<12>(a, s);
    return launch<32>(a, s);
}

// The chain probe: `steps` dependent operations `op` (see
// lpc_op_probe_kernel) in one thread, each on its own start value; sink
// [1] float64 and cycles [1] int64 device pointers.  Synchronous.
int flac_lpc_op_probe(int op, int steps, void* sink, void* cycles) {
    const double x[] = {1.0, 2.0, 2.5, 1.25, 1.0000001};
    lpc_op_probe_kernel<<<1, 1>>>(op, x[op < 0 || op > 4 ? 4 : op], steps,
                                  (double*)sink, (long long*)cycles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}

}  // extern "C"
