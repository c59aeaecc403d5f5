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
// Design: one thread a (r, a) problem, looping over its own candidates
// (every order with -e, every precision with -p); the recursion's state
// lives in the thread's local arrays.  Without -e the thread runs the
// recursion once for the errors, guesses the order, and runs it again up
// to that order for the coefficients (the same operations, so the same
// values).  At -5 a batch of 64 stereo frames is 256 problems of order 8,
// at -8 some thousands of order 12, ~50 KB of data in all: the bound is
// the serial chain of dependent float64 operations in one thread and the
// launch, not bytes.  lpc_chain_probe measures the dependent latency of
// the chain's float64 add, from which chip_smoke.py states that floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ORDER = 32;          // format.MAX_LPC_ORDER
constexpr int MIN_PREC = 5;            // format.MIN_QLP_COEFF_PRECISION
constexpr int MAX_PREC = 15;           // format.MAX_QLP_COEFF_PRECISION
constexpr int MAX_SHIFT = 15;
constexpr int MIN_SHIFT = -16;
constexpr int THREADS = 64;

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

// estimate_best_order's est_bps for one error
__device__ __forceinline__ double est_bps(double err, double scale) {
    if (err > 0.0) {
        const double b = __dmul_rn(0.5, log2(__dmul_rn(err, scale)));
        return b < 0.0 ? 0.0 : b;
    }
    return err < 0.0 ? 1e32 : 0.0;
}

// one step i of Levinson-Durbin on (lpc, err), rounded as
// ops/lpc.py levinson_all_orders rounds it
__device__ __forceinline__ void levinson_step(int i, const double* ac,
                                              double* lpc, double& err) {
    double s = 0.0;
    for (int j = 0; j < i; ++j)
        s = __dadd_rn(s, __dmul_rn(lpc[j], ac[i - j]));
    const double safe = err == 0.0 ? 1.0 : err;
    const double r = __ddiv_rn(-__dadd_rn(ac[i + 1], s), safe);
    // lpc'[j] = lpc[j] + r * lpc[i-1-j] for j < i (from the old values)
    for (int j = 0, k = i - 1; j < k; ++j, --k) {
        const double a = lpc[j], b = lpc[k];
        lpc[j] = __dadd_rn(a, __dmul_rn(r, b));
        lpc[k] = __dadd_rn(b, __dmul_rn(r, a));
    }
    if (i & 1) {
        const int m = (i - 1) >> 1;
        lpc[m] = __dadd_rn(lpc[m], __dmul_rn(r, lpc[m]));
    }
    lpc[i] = r;
    err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(r, r)));
}

// quantize_coefficients for one candidate: c[] the float32 coefficients
// (as doubles, zero past `order`); writes qc[32], returns the shift and
// sets `valid`
__device__ int quantize(const double* c, int order, int prec, int* qc,
                        bool& valid) {
    double cmax = 0.0;
    for (int j = 0; j < order; ++j) {
        const double a = fabs(c[j]);
        cmax = (a > cmax || a != a) ? a : cmax;     // max, NaN sticks
    }
    valid = cmax > 0.0;
    const double safe = valid ? cmax : 1.0;
    int e0 = (int)floor(log2(safe));
    if (pow2(e0) > safe) e0 = wsub(e0, 1);
    const int log2cmax = pow2(wadd(e0, 1)) <= safe ? wadd(e0, 1) : e0;
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
    double error = 0.0;
    for (int j = 0; j < MAX_ORDER; ++j) {
        const double e = __dadd_rn(error, __dmul_rn(c[j], scale));
        double q = 0.0;
        const bool in = j < order;
        if (in) {
            const double sgn = (double)((0.0 < e) - (e < 0.0));
            q = __dmul_rn(sgn, floor(__dadd_rn(fabs(e), 0.5)));
        }
        q = q < qmin ? qmin : q;        // torch.maximum, then minimum
        q = q > qmax ? qmax : q;
        if (in) error = __dsub_rn(e, q);
        qc[j] = (int)q;
    }
    return shift > 0 ? shift : 0;
}

struct Out {
    int* qc;
    int* qshift;
    int* order;
    int* prec;
    unsigned char* ok;
};

// quantize candidate `slot` (coefficients c of `order`) at every precision
// of its grid, writing nP consecutive candidates from slot * nP
__device__ void emit(const Out& out, long long slot, const double* c,
                     int order, bool cand_ok, int bps, int static_prec,
                     bool prec_search) {
    const int nP = prec_search ? MAX_PREC - MIN_PREC + 1 : 1;
    int clamp;
    if (prec_search) {
        const int v = wsub(wsub(32, bps), ilog2(order));
        clamp = bps <= 17 ? (v > MIN_PREC ? v : MIN_PREC) : MAX_PREC;
    } else {
        const int v = wsub(wsub(32, bps), ilog2(order));
        clamp = bps <= 17 ? (v < static_prec ? v : static_prec)
                          : static_prec;
    }
    for (int p = 0; p < nP; ++p) {
        const long long k = slot * nP + p;
        const int prec = prec_search ? MIN_PREC + p : clamp;
        const bool ok_p = !prec_search || prec <= clamp;
        bool q_ok;
        const int sh = quantize(c, order, prec, out.qc + k * MAX_ORDER, q_ok);
        out.qshift[k] = sh;
        out.order[k] = order;
        out.prec[k] = prec;
        out.ok[k] = (unsigned char)(cand_ok && ok_p && q_ok);
    }
}

// the float32 coefficients of an order, as the plain version gathers them:
// (-lpc).to(float32), zero when the order is dead, then back to float64
__device__ __forceinline__ void coefficients(const double* lpc, int order,
                                             bool dead, double* c) {
    for (int j = 0; j < MAX_ORDER; ++j)
        c[j] = (j < order && !dead) ? (double)(float)(-lpc[j]) : 0.0;
}

__global__ void __launch_bounds__(THREADS) lpc_coeffs_kernel(
        const double* __restrict__ autoc, const int* __restrict__ bps_in,
        Out out, int R, int A, int O, int N, int exhaustive,
        int prec_search, int static_prec) {
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= R * A) return;
    const int r = t / A, a = t - r * A;
    const int bps = bps_in[r];
    double ac[MAX_ORDER + 1], lpc[MAX_ORDER], c[MAX_ORDER];
    for (int l = 0; l <= O; ++l) ac[l] = autoc[(long long)t * (O + 1) + l];
    for (int j = 0; j < MAX_ORDER; ++j) lpc[j] = 0.0;
    double err = ac[0];
    bool dead = err == 0.0;
    const double bpsd = (double)bps;

    if (exhaustive) {
        // every order is a candidate, quantized as the recursion makes it;
        // its own estimate at scale 0.5 / (N - order)
        const long long base = (long long)r * A * O + (long long)a * O;
        for (int i = 0; i < O; ++i) {
            levinson_step(i, ac, lpc, err);
            const int order = i + 1;
            const double scale =
                __dmul_rn(__drcp_rn((double)(N - order)), 0.5);
            const bool ok = !dead && est_bps(err, scale) < bpsd;
            coefficients(lpc, order, dead, c);
            emit(out, base + i, c, order, ok, bps, static_prec,
                 prec_search != 0);
            dead = dead || err == 0.0;
        }
        return;
    }

    // the errors of every order, then the guess (first index on ties)
    double errs[MAX_ORDER];
    bool was_dead[MAX_ORDER];
    for (int i = 0; i < O; ++i) {
        levinson_step(i, ac, lpc, err);
        errs[i] = err;
        was_dead[i] = dead;
        dead = dead || err == 0.0;
    }
    const double scale_n = __ddiv_rn(0.5, (double)N);
    const double ovh = (double)wadd(bps, static_prec);
    int best = 0;
    double best_bits = 0.0;
    for (int i = 0; i < O; ++i) {
        const double o = (double)(i + 1);
        const double bits = __dadd_rn(
            __dmul_rn(est_bps(errs[i], scale_n), (double)N - o),
            __dmul_rn(o, ovh));
        if (i == 0 || bits < best_bits) {
            best = i;
            best_bits = bits;
        }
    }
    const int order = best + 1;
    const double scale = __dmul_rn(__drcp_rn((double)(N - order)), 0.5);
    const bool ok = !was_dead[best] && est_bps(errs[best], scale) < bpsd;
    // the guessed order's coefficients: the recursion again, up to it
    for (int j = 0; j < MAX_ORDER; ++j) lpc[j] = 0.0;
    err = ac[0];
    for (int i = 0; i < order; ++i) levinson_step(i, ac, lpc, err);
    coefficients(lpc, order, was_dead[best], c);
    emit(out, (long long)t, c, order, ok, bps, static_prec,
         prec_search != 0);
}

// the dependent latency of the chain's float64 add: one thread runs
// `steps` dependent __dadd_rn and writes the clock64 cycles they took
__global__ void lpc_chain_probe_kernel(double x, int steps, double* sink,
                                       long long* cycles) {
    double v = x;
    const long long t0 = clock64();
    for (int i = 0; i < steps; ++i) v = __dadd_rn(v, x);
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
    Out out{(int*)qc, (int*)qshift, (int*)order, (int*)prec,
            (unsigned char*)ok};
    const int problems = R * A;
    lpc_coeffs_kernel<<<(problems + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const double*)autoc, (const int*)bps, out, R, A, O, N, exhaustive,
        prec_search, static_prec);
    return (int)cudaGetLastError();
}

// The chain probe: `steps` dependent float64 adds in one thread; sink [1]
// float64 and cycles [1] int64 device pointers.  Synchronous.
int flac_lpc_chain_probe(int steps, void* sink, void* cycles) {
    lpc_chain_probe_kernel<<<1, 1>>>(1.0, steps, (double*)sink,
                                     (long long*)cycles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}

}  // extern "C"
