// The encoder's channel assignment (kernel K12 of flac_tpu_torch).
//
// Replaces flac_tpu/encoder.py:62-80 on the stereo mid-side path:
// select_assignment (flac_tpu/models/stereo.py:109), both gather_channels
// calls (:134) and the limit_min_bitrate rule, which XLA fuses into the
// jitted encode_batch on the TPU and the port ran as some thirty-five
// small torch kernels a batch (an expand and a gather for each of the 13
// SubframeChoice fields and the signal).  Same contract as
// flac_tpu_torch/models/stereo.py assign_channels_plain, its plain version,
// bit for bit: for every frame b, from its four candidates' (L, R, M, S)
// subframe choices and signals, the assignment a: the loose one where
// it is given (K10's), else the first index of the least of the totals
// L + R, L + S, R + S, M + S (wrapping int32 adds, as torch.argmin takes
// them; stream_encoder.c:3944-3971); then for each output channel j its
// candidate's fields, coefficients, warm-up, parameter row, residual row
// and signal row, and, under limit_min_bitrate, channel 1 VERBATIM where
// both channels' subframes are CONSTANT (stream_encoder.c:3874-3879).
//
// Design (Hopper): a CTA of 256 threads a (frame, output channel): each
// thread forms the frame's assignment (four loads the warp shares), thread
// 0 writes the scalars, and the CTA copies the small rows and then the
// residual and signal rows with 16-byte loads and stores.  The bound is
// bytes: the chosen two of the four residual rows and signal rows read and
// written (8.4 MB at -5: ~2.5 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // threads a CTA
constexpr int CAND = 4;                 // candidates L, R, M, S
constexpr int COEFFS = 32;              // coefficients, warm-up samples
// fmt.SUBFRAME_TYPE_*
constexpr int TYPE_CONSTANT = 0, TYPE_VERBATIM = 1;
// each assignment's (ch0, ch1) candidates: independent, left-side,
// right-side, mid-side (stereo.py _ASSIGN_CH0, _ASSIGN_CH1)
__constant__ int CH0[4] = {0, 0, 3, 2};
__constant__ int CH1[4] = {1, 3, 1, 3};

struct Args {
    // the candidates' SubframeChoice fields, [B, 4, ...], and the signals
    const int *bits, *type, *order, *wasted, *bps_eff, *qc, *shift, *prec;
    const void* warmup;                 // [B, 4, 32] x's type
    const int *residual, *po, *params;
    const unsigned char* rice2;
    const void* x;                      // [B, 4, N] int32 or int64
    const int* loose;                   // [B] or null
    // the stream channels' outputs, [B, 2, ...]
    int* assignment;                    // [B]
    int *o_bits, *o_type, *o_order, *o_wasted, *o_bps_eff, *o_qc, *o_shift,
        *o_prec;
    void* o_warmup;
    int *o_residual, *o_po, *o_params;
    unsigned char* o_rice2;
    void* signal;                       // [B, 2, N]
    int N, P, limit_min;
    int vec_res, vec_sig;               // 16-byte copies of the rows
};

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// a row of N values of T, with 16-byte loads and stores where `vec`
template <typename T>
__device__ __forceinline__ void copy_row(const T* src, T* dst, int N,
                                         bool vec, int t) {
    if (vec) {
        const int n4 = N * (int)sizeof(T) / 16;
        for (int i = t; i < n4; i += THREADS)
            reinterpret_cast<int4*>(dst)[i] =
                __ldg(reinterpret_cast<const int4*>(src) + i);
    } else {
        for (int i = t; i < N; i += THREADS) dst[i] = src[i];
    }
}

template <typename X>
__global__ void __launch_bounds__(THREADS)
assign_channels_kernel(const Args a) {
    const int t = threadIdx.x;
    const int b = blockIdx.x >> 1, j = blockIdx.x & 1;
    const int N = a.N, P = a.P;
    int asg;
    if (a.loose != nullptr) {
        asg = a.loose[b];
    } else {
        const int* bb = a.bits + (size_t)b * CAND;
        const int tot[4] = {wadd(bb[0], bb[1]), wadd(bb[0], bb[3]),
                            wadd(bb[1], bb[3]), wadd(bb[2], bb[3])};
        asg = 0;
#pragma unroll
        for (int k = 1; k < 4; ++k)
            if (tot[k] < tot[asg]) asg = k;
    }
    const int c0 = CH0[asg], c = j ? CH1[asg] : c0;
    const size_t in = (size_t)b * CAND + c, out = (size_t)b * 2 + j;
    if (t == 0) {
        int type = a.type[in];
        if (a.limit_min && j == 1 && type == TYPE_CONSTANT
                && a.type[(size_t)b * CAND + c0] == TYPE_CONSTANT)
            type = TYPE_VERBATIM;
        a.o_type[out] = type;
        a.o_bits[out] = a.bits[in];
        a.o_order[out] = a.order[in];
        a.o_wasted[out] = a.wasted[in];
        a.o_bps_eff[out] = a.bps_eff[in];
        a.o_shift[out] = a.shift[in];
        a.o_prec[out] = a.prec[in];
        a.o_po[out] = a.po[in];
        a.o_rice2[out] = a.rice2[in];
        if (j == 0) a.assignment[b] = asg;
    }
    if (t < COEFFS) {
        a.o_qc[out * COEFFS + t] = a.qc[in * COEFFS + t];
    } else if (t < 2 * COEFFS) {
        const int i = t - COEFFS;
        static_cast<X*>(a.o_warmup)[out * COEFFS + i] =
            static_cast<const X*>(a.warmup)[in * COEFFS + i];
    }
    for (int i = t; i < P; i += THREADS)
        a.o_params[out * P + i] = a.params[in * P + i];
    copy_row(a.residual + in * N, a.o_residual + out * N, N, a.vec_res, t);
    copy_row(static_cast<const X*>(a.x) + in * N,
             static_cast<X*>(a.signal) + out * N, N, a.vec_sig, t);
}

}  // namespace

extern "C" {

// K12 on B stereo frames of N samples and P Rice parameters a subframe:
// the 13 SubframeChoice fields of the four candidates (bits, type, order,
// wasted, bps_eff, qcoeffs, shift, precision, warmup, residual, po,
// params, use_rice2), the signals x and the loose assignment (null when
// the totals decide), then the assignment, the 13 fields of the two
// output channels and their signal, all device pointers; x64 when x (and
// the warm-up) is int64.  Returns the CUDA error code of the launch (0 on
// success).
int flac_assign_channels(
        const void* bits, const void* type, const void* order,
        const void* wasted, const void* bps_eff, const void* qc,
        const void* shift, const void* prec, const void* warmup,
        const void* residual, const void* po, const void* params,
        const void* rice2, const void* x, const void* loose,
        void* assignment, void* o_bits, void* o_type, void* o_order,
        void* o_wasted, void* o_bps_eff, void* o_qc, void* o_shift,
        void* o_prec, void* o_warmup, void* o_residual, void* o_po,
        void* o_params, void* o_rice2, void* signal, int B, int N, int P,
        int x64, int limit_min, void* stream) {
    if (B <= 0) return 0;
    if (N < 1 || P < 1) return (int)cudaErrorInvalidValue;
    auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    const int xs = x64 ? 8 : 4;
    const Args a{
        (const int*)bits, (const int*)type, (const int*)order,
        (const int*)wasted, (const int*)bps_eff, (const int*)qc,
        (const int*)shift, (const int*)prec, warmup, (const int*)residual,
        (const int*)po, (const int*)params, (const unsigned char*)rice2, x,
        (const int*)loose, (int*)assignment, (int*)o_bits, (int*)o_type,
        (int*)o_order, (int*)o_wasted, (int*)o_bps_eff, (int*)o_qc,
        (int*)o_shift, (int*)o_prec, o_warmup, (int*)o_residual, (int*)o_po,
        (int*)o_params, (unsigned char*)o_rice2, signal, N, P, limit_min,
        (int)(N % 4 == 0 && aligned(residual) && aligned(o_residual)),
        (int)((N * xs) % 16 == 0 && aligned(x) && aligned(signal))};
    const cudaStream_t s = (cudaStream_t)stream;
    if (x64) assign_channels_kernel<long long><<<2 * B, THREADS, 0, s>>>(a);
    else assign_channels_kernel<int><<<2 * B, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
