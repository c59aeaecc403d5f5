// The encoder's select and realize (kernel K9 of flac_tpu_torch).
//
// Replaces the select of flac_tpu/models/subframe.py search_and_realize:
// the verbatim and constant bits (:123-128), each candidate's cheapest
// partition order (rice_best and po_all, :243-244), the header bits and
// total_all (:246-258), the argmin over [verbatim, constant, fixed 0-4,
// LPC ...] (:260-266), the realize of the winner through _select_c (:92,
// :275-296) and the warm-up (:298-299), which XLA fuses into the jitted
// encode_batch on the TPU and the port ran as some forty small torch
// kernels a batch.  Same contract as flac_tpu_torch/models/subframe.py
// select_and_realize_plain, its plain version, bit for bit: for every
// (frame and channel candidate) row r, from its signal x[r, 0..N), its
// bps and wasted bits, its candidates' residual rows res[r, C, N], orders,
// flags, LPC parameters and Rice cost tables (bits [C, L], parameters
// [C, L, P], RICE2 flags [C, L]), the winner's bits, type, order,
// coefficients, shift, precision, warm-up (x's first 32 samples, zero
// past N), residual row, partition order, parameter row and RICE2 flag.
//
// Exactness: every quantity is an integer; the header and total bits add
// in wrapping int32 as the plain version's tensors do; each argmin (over
// the partition orders, and over the candidates) takes the first index of
// the least value, as torch.argmin does.  A verbatim or constant winner
// takes fixed order 0's parameter row and RICE2 flag at partition order 0
// (the plain version's selects at the clamped index).
//
// Design (Hopper): a CTA of 256 threads a row.  The threads test the
// signal for a constant block (coalesced loads, __syncthreads_or) and
// cost a candidate each (its L partition-order bits, its header and
// flags); a shuffle butterfly on (bits, index) then one warp over the 8
// warps' winners give the first-index argmin.  Then thread 0 finds the
// winner's partition order, and the CTA writes the outputs: the winner's
// residual row copied with 16-byte loads and stores (scalar where N % 4 !=
// 0), only its partition order's parameter row, its 32 coefficients and
// the warm-up.  The bound is bytes: the signal read once, the winner's
// residual row read and the realized row written (12.6 MB at -5).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // threads a CTA
constexpr int WARPS = THREADS / 32;
constexpr int FIXED = 5;               // fixed orders 0..4
constexpr int MAX_ORDER = 32;          // coefficients, warm-up samples
constexpr int BIG = 1 << 28;           // ops/rice.py BIG
constexpr unsigned FULL = 0xFFFFFFFFu;
// fmt.SUBFRAME_TYPE_*
constexpr int TYPE_CONSTANT = 0, TYPE_VERBATIM = 1, TYPE_FIXED = 2,
              TYPE_LPC = 3;

struct Args {
    // inputs
    const void* x;                   // [R, N] int32 or int64
    const int* bps;                  // [R]
    const int* wasted;               // [R]
    const int* res;                  // [R, C, N]
    const int* order_all;            // [R, C]
    const unsigned char* f_ok;       // [R, 5]
    const unsigned char* cand_ok;    // [R, AC]
    const unsigned char* fit_ok;     // [R, AC]
    const int* prec;                 // [R, AC]
    const int* qc;                   // [R, AC, 32]
    const int* qshift;               // [R, AC]
    const int* r_bits;               // [R, C, L]
    const int* r_ks;                 // [R, C, L, P]
    const unsigned char* r_rice2;    // [R, C, L]
    // outputs
    int* bits;                       // [R]
    int* type;                       // [R]
    int* order;                      // [R]
    int* qc_out;                     // [R, 32]
    int* shift;                      // [R]
    int* prec_out;                   // [R]
    void* warmup;                    // [R, 32] x's type
    int* residual;                   // [R, N]
    int* po;                         // [R]
    int* params;                     // [R, P]
    unsigned char* use_rice2;        // [R]
    int AC, N, L, P;
    int vec;                         // N % 4 == 0, res and residual aligned
};

// int32 arithmetic that wraps, as torch's does
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}

// (bits, index) a before b: less bits, or as many and a lower index
__device__ __forceinline__ bool before(int ba, int ia, int bb, int ib) {
    return ba < bb || (ba == bb && ia < ib);
}

// the first index of the least of a row's L partition-order bits
__device__ __forceinline__ int first_argmin(const int* v, int L, int* best) {
    int m = v[0], at = 0;
    for (int l = 1; l < L; ++l)
        if (v[l] < m) { m = v[l]; at = l; }
    *best = m;
    return at;
}

template <typename X>
__global__ void __launch_bounds__(THREADS)
select_realize_kernel(const Args a) {
    __shared__ int s_bits[WARPS], s_idx[WARPS];
    __shared__ int s_win, s_po;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int r = blockIdx.x;
    const int N = a.N, AC = a.AC, C = FIXED + AC, L = a.L, P = a.P;
    const X* x = static_cast<const X*>(a.x) + (size_t)r * N;
    const int bps = a.bps[r];
    const int ovh = wadd(8, a.wasted[r]);       // subframe header bits

    // the constant test
    const X x0 = x[0];
    int differs = 0;
    for (int n = t; n < N; n += THREADS) differs |= x[n] != x0;
    const int is_const = !__syncthreads_or(differs);

    // every candidate's bits, a thread a candidate: index c + 2 in
    // [verbatim, constant, fixed 0..4, LPC ...]
    int best = INT_MAX, best_i = INT_MAX;
    if (t == 0) {
        best = wadd(ovh, wmul(N, bps));                       // verbatim
        best_i = 0;
        const int cb = is_const ? wadd(ovh, bps) : BIG;      // constant
        if (before(cb, 1, best, best_i)) { best = cb; best_i = 1; }
    }
    for (int c = t; c < C; c += THREADS) {
        int rice;
        first_argmin(a.r_bits + ((size_t)r * C + c) * L, L, &rice);
        int hdr;
        bool ok;
        if (c < FIXED) {
            hdr = wadd(ovh, wmul(c, bps));
            ok = a.f_ok[(size_t)r * FIXED + c] && c < N;
        } else {
            const size_t l = (size_t)r * AC + (c - FIXED);
            hdr = wadd(wadd(ovh, 9), wmul(a.order_all[(size_t)r * C + c],
                                          wadd(a.prec[l], bps)));
            ok = a.cand_ok[l] && a.fit_ok[l];
        }
        const int total = ok && rice < BIG ? wadd(hdr, min(rice, BIG)) : BIG;
        if (before(total, c + 2, best, best_i)) { best = total; best_i = c + 2; }
    }
    // the first-index argmin: a butterfly in each warp, then warp 0
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const int ob = __shfl_xor_sync(FULL, best, m);
        const int oi = __shfl_xor_sync(FULL, best_i, m);
        if (before(ob, oi, best, best_i)) { best = ob; best_i = oi; }
    }
    if (lane == 0) { s_bits[warp] = best; s_idx[warp] = best_i; }
    __syncthreads();
    if (warp == 0) {
        best = lane < WARPS ? s_bits[lane] : INT_MAX;
        best_i = lane < WARPS ? s_idx[lane] : INT_MAX;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
            const int ob = __shfl_xor_sync(FULL, best, m);
            const int oi = __shfl_xor_sync(FULL, best_i, m);
            if (before(ob, oi, best, best_i)) { best = ob; best_i = oi; }
        }
        if (lane == 0) {
            const int win = best_i;
            const bool has_res = win >= 2;
            const int wc = min(max(win - 2, 0), C - 1);
            const size_t row = (size_t)r * C + wc;
            int unused;
            const int po = has_res ? first_argmin(a.r_bits + row * L, L,
                                                  &unused) : 0;
            const bool lpc = win >= 2 + FIXED;
            const size_t li = (size_t)r * AC + min(max(win - 7, 0), AC - 1);
            a.bits[r] = best;
            a.type[r] = win == 0 ? TYPE_VERBATIM : win == 1 ? TYPE_CONSTANT
                      : lpc ? TYPE_LPC : TYPE_FIXED;
            a.order[r] = has_res ? a.order_all[row] : 0;
            a.po[r] = po;
            a.use_rice2[r] = a.r_rice2[row * L + po];
            a.shift[r] = lpc ? a.qshift[li] : 0;
            a.prec_out[r] = lpc ? a.prec[li] : 0;
            s_win = win;
            s_po = po;
        }
    }
    __syncthreads();

    // the realize: the parameter row, the coefficients, the warm-up, the
    // residual row
    const int win = s_win;
    const bool has_res = win >= 2, lpc = win >= 2 + FIXED;
    const size_t row = (size_t)r * C + min(max(win - 2, 0), C - 1);
    const int* ks = a.r_ks + (row * L + s_po) * P;
    for (int i = t; i < P; i += THREADS) a.params[(size_t)r * P + i] = ks[i];
    if (t < MAX_ORDER) {
        const size_t li = (size_t)r * AC + min(max(win - 7, 0), AC - 1);
        a.qc_out[(size_t)r * MAX_ORDER + t] =
            lpc ? a.qc[li * MAX_ORDER + t] : 0;
    } else if (t < 2 * MAX_ORDER) {
        const int j = t - MAX_ORDER;
        static_cast<X*>(a.warmup)[(size_t)r * MAX_ORDER + j] =
            j < N ? x[j] : X(0);
    }
    int* out = a.residual + (size_t)r * N;
    const int* src = a.res + row * N;
    if (a.vec) {
        const int4 zero = make_int4(0, 0, 0, 0);
        for (int i = t; i < N / 4; i += THREADS)
            reinterpret_cast<int4*>(out)[i] = has_res
                ? __ldg(reinterpret_cast<const int4*>(src) + i) : zero;
    } else {
        for (int i = t; i < N; i += THREADS)
            out[i] = has_res ? src[i] : 0;
    }
}

}  // namespace

extern "C" {

// K9 on R = B * CH rows with C = 5 + AC candidates, L partition orders
// and P parameters a row: the 14 inputs, then the 11 outputs (see Args),
// all device pointers; x64 when x (and the warm-up) is int64.  Returns
// the CUDA error code of the launch (0 on success).
int flac_select_realize(
        const void* x, const void* bps, const void* wasted, const void* res,
        const void* order_all, const void* f_ok, const void* cand_ok,
        const void* fit_ok, const void* prec, const void* qc,
        const void* qshift, const void* r_bits, const void* r_ks,
        const void* r_rice2, void* bits, void* type, void* order,
        void* qc_out, void* shift, void* prec_out, void* warmup,
        void* residual, void* po, void* params, void* use_rice2, int R,
        int AC, int N, int L, int P, int x64, void* stream) {
    if (R <= 0) return 0;
    if (N < 1 || AC < 0 || L < 1 || P < 1) return (int)cudaErrorInvalidValue;
    Args a{x, (const int*)bps, (const int*)wasted, (const int*)res,
           (const int*)order_all, (const unsigned char*)f_ok,
           (const unsigned char*)cand_ok, (const unsigned char*)fit_ok,
           (const int*)prec, (const int*)qc, (const int*)qshift,
           (const int*)r_bits, (const int*)r_ks,
           (const unsigned char*)r_rice2, (int*)bits, (int*)type,
           (int*)order, (int*)qc_out, (int*)shift, (int*)prec_out, warmup,
           (int*)residual, (int*)po, (int*)params,
           (unsigned char*)use_rice2, AC, N, L, P,
           (int)(N % 4 == 0 && ((uintptr_t)res & 15) == 0
                 && ((uintptr_t)residual & 15) == 0)};
    const cudaStream_t s = (cudaStream_t)stream;
    if (x64) select_realize_kernel<long long><<<R, THREADS, 0, s>>>(a);
    else select_realize_kernel<int><<<R, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
