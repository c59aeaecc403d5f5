"""Kernel K3: the LPC restore, wasted-bit shift and stereo undo of the
decoders, hand-written CUDA.

Replaces flac_tpu/ops/bitunpack.py:53-120, restore_undo_body: an XLA
lax.scan that both the device engine (after the code scan, K2) and the
"fast" engine (after the native full parse) run as one compiled program.
Its plain version is the port's `bitunpack.restore_undo_body`, an eager
loop of about six launches a sample step.  The source is csrc/restore.cu,
designed for Hopper: CTAs of 32 subframes whose warps split the work.  A
recursion warp (a lane a subframe) runs only the chain, with MO lookahead
accumulators in registers and, where every subframe of the warp allows it,
the residual folded into the sum so that a sample costs one multiply-add
and one funnel shift on the chain, the older taps' sums kept as exact
doubles on the FP64 pipe; a producer warp streams residual chunks
of K samples into a shared-memory ring (cp.async.bulk where rows are
16-byte aligned, plain loads otherwise); two epilogue warps apply the
wasted bits, the stereo undo, the range flags and the int16 narrowing and
store coalesced.  `mirror_restore` is the host mirror of the recursion's
arithmetic and of its rule for the folded form.

Bound: a full -5 batch (1024 stereo frames of 4096 samples) reads res once
(33.5 MB in int32) and writes pcm once (16.8 MB in int16): ~0.015 ms at
3.35 TB/s.  Each CTA's chain of 4096 samples sets a floor of its own,
~0.04 ms on an H100 (chip_smoke.py reports it as `chain_floor_ms` beside
the bound).

`restore_undo` dispatches on the tensors' device: the plain version for
CPU tensors, the kernel for CUDA tensors (it launches or raises; there is no
fallback).  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import bitunpack

SOURCE = "flac_tpu_torch/csrc/restore.cu"
REPLACES = "flac_tpu/ops/bitunpack.py:53"     # restore_undo_body
LIB_NAME = "restore"
ORDER_BUCKETS = (1, 2, 4, 8, 12, 16, 32)      # the kernel's templates
# constants of the source (tests/test_torch_policy.py holds them equal)
THREADS = 128         # a CTA: the recursion, producer and 2 epilogue warps
SUBS = 32             # subframes a CTA
GROUP = 8             # int16 samples in 16 bytes; N % GROUP == 0 keeps
                      # every pcm row 16-byte aligned
K = 96                # samples a ring chunk
IN_STAGES, OUT_STAGES, IN_PAD, BARS_BYTES = 3, 2, 16, 128

launches = 0          # kernel launches of restore_undo_cuda in this process
_lib = None
_RES_TYPES = (torch.int16, torch.int32, torch.int64)


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(LIB_NAME)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flac_restore.argtypes = [p, i, ctypes.c_longlong, i, p, p, p, i,
                                     p, p, p, i, i, p, i, i, i, i, i, p]
        lib.flac_restore.restype = ctypes.c_int
        lib.flac_restore_smem.argtypes = [i, i]
        lib.flac_restore_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_order(max_order: int) -> int:
    """The kernel's order bucket for `max_order` taps: the least of
    ORDER_BUCKETS at or above it (missing taps are zeros, and a batch
    without taps gets one)."""
    for b in ORDER_BUCKETS:
        if max_order <= b:
            return b
    raise ValueError(f"restore_undo_cuda: max_order={max_order} (at most "
                     f"{ORDER_BUCKETS[-1]})")


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def smem_bytes(rbytes: int, wide: bool) -> int:
    """Dynamic shared memory of a launch (smem_bytes in the source): the
    barriers, IN_STAGES residual stages of SUBS rows of K samples padded by
    IN_PAD bytes, OUT_STAGES x stages of SUBS rows of K int32 (int64 wide)."""
    return (BARS_BYTES + IN_STAGES * SUBS * (K * rbytes + IN_PAD)
            + OUT_STAGES * SUBS * K * (8 if wide else 4))


def restore_undo_cuda(res, order, shift, qlp, wasted, assignment, *,
                      blocksize: int, channels: int, max_order: int,
                      wide: bool = False, out16: bool = False, bps: int = 0):
    """Launch K3 on one CUDA device; the contract of
    `bitunpack.restore_undo_body`: res [S, >= blocksize] int16/int32/int64
    (unit stride along the samples), order/shift/wasted [S], qlp
    [S, >= max_order] int32, assignment [B] (S = B * channels).  Returns
    ([B, channels, blocksize] PCM, [B] bool out-of-range flags)."""
    global launches
    N, C = blocksize, channels
    dev = res.device
    for name, t in (("res", res), ("order", order), ("shift", shift),
                    ("qlp", qlp), ("wasted", wasted),
                    ("assignment", assignment)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"restore_undo_cuda: {name} is not on the GPU "
                             "of res")
    if res.ndim != 2 or res.dtype not in _RES_TYPES:
        raise ValueError(f"restore_undo_cuda: res is {res.dtype} of shape "
                         f"{tuple(res.shape)}, want [S, N] int16/32/64")
    S = res.shape[0]
    if C < 1 or S % C or res.shape[1] < N or N < 0:
        raise ValueError(f"restore_undo_cuda: res {tuple(res.shape)} for "
                         f"blocksize {N} and {C} channels")
    if order.shape != (S,) or shift.shape != (S,) or wasted.shape != (S,):
        raise ValueError("restore_undo_cuda: order, shift and wasted must be "
                         f"[{S}]")
    if qlp.ndim != 2 or qlp.shape[0] != S or qlp.shape[1] < max_order \
            or qlp.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"restore_undo_cuda: qlp is {qlp.dtype} of shape "
                         f"{tuple(qlp.shape)}, want [{S}, >= {max_order}] "
                         "int32")
    B = S // C
    if C == 2 and assignment.numel() < B:
        raise ValueError(f"restore_undo_cuda: assignment has "
                         f"{assignment.numel()} entries, want {B}")
    if not 0 <= bps <= 32:
        raise ValueError(f"restore_undo_cuda: bps={bps} (0..32)")
    mo = kernel_order(max_order)
    if res.stride(1) != 1:
        res = res.contiguous()
    if mo == max_order:
        q = qlp[:, :mo].to(torch.int32).contiguous()
    else:
        q = torch.zeros((S, mo), dtype=torch.int32, device=dev)
        q[:, :max_order] = qlp[:, :max_order]
    order, shift, wasted = (t.to(torch.int32).contiguous()
                            for t in (order, shift, wasted))
    asg = assignment.to(torch.int32).contiguous()
    out_t = torch.int16 if out16 else (torch.int64 if wide else torch.int32)
    pcm = torch.empty((B, C, N), dtype=out_t, device=dev)
    oor = torch.zeros((B,), dtype=torch.bool, device=dev)
    if S == 0 or N == 0:
        return pcm, oor
    rbytes = res.element_size()
    # bulk copies need 16-byte aligned rows; the kernel copies a tail chunk
    # of another length with plain loads
    vec_in = _aligned16(res) and res.stride(0) * rbytes % 16 == 0
    vec_out = N % GROUP == 0 and _aligned16(pcm)
    with torch.cuda.device(dev):
        lib = _library()
        kernels.check(lib.flac_restore(
            res.data_ptr(), rbytes, res.stride(0), int(vec_in),
            order.data_ptr(), shift.data_ptr(), q.data_ptr(), mo,
            wasted.data_ptr(), asg.data_ptr(), pcm.data_ptr(), int(out16),
            int(vec_out), oor.data_ptr(), S, N, C, int(wide), bps,
            torch.cuda.current_stream().cuda_stream), "flac_restore launch")
    launches += 1
    return pcm, oor


# ---------------------------------------------------------------------------
# The host mirror of the kernel's arithmetic
# ---------------------------------------------------------------------------

def round_len(mo: int) -> int:
    """Samples a round of the recursion for order bucket `mo` (round_len in
    the source): a multiple of mo and of GROUP."""
    return 3 * GROUP if mo == 12 else 4 * GROUP


def folded_subframes(qlp, shift, wide: bool = False) -> np.ndarray:
    """[S] bool: the subframes whose recursion takes the folded form
    x = (P + (r << sh)) >> sh.  It is exact for taps of 16 signed bits and
    shifts 0..31 (then |P| < 2^51 and |r 2^sh| < 2^62, nothing wraps);
    the lanes of one warp share one loop, so a warp (SUBS subframes, a
    CTA) folds only when all its subframes qualify.  Wide batches never
    fold."""
    qlp, shift = np.asarray(qlp), np.asarray(shift)
    S = shift.shape[0]
    if wide:
        return np.zeros(S, bool)
    ok = (((qlp >= -(1 << 15)) & (qlp < 1 << 15)).all(1)
          & (shift >= 0) & (shift <= 31))
    ok = np.concatenate([ok, np.ones(-S % SUBS, bool)])
    return np.repeat(ok.reshape(-1, SUBS).all(1), SUBS)[:S]


def _xt(v, wide: bool) -> np.ndarray:
    """uint64 -> the sample type's value (int32 narrow, int64 wide) held in
    int64."""
    v = v.view(np.int64)
    return v if wide else v.astype(np.int32).astype(np.int64)


def mirror_restore(res, order, shift, qlp, wasted, assignment, *,
                   blocksize: int, channels: int, max_order: int,
                   wide: bool = False, out16: bool = False, bps: int = 0):
    """The kernel's arithmetic in numpy, on the contract of
    `bitunpack.restore_undo_body` (numpy arrays in, numpy (pcm, oor) out).

    The recursion as csrc/restore.cu runs it, in rounds of round_len(MO)
    samples, MO = kernel_order(max_order).  The generic form, for a CTA
    that does not fold (`folded_subframes`) and for any round in which a
    subframe of the CTA is still in its warm-up: MO lookahead accumulators
    P (wrapping int64), sample n's in P[n % MO]; x[n] = r[n] +
    (P[n % MO] >> sh_eff) (sh_eff = 63 for a shift below 0 or at 64 or
    more; the warm-up samples pass through), then the slot is reborn for
    sample n + MO and every accumulator takes q[j] * x[n] for the sample
    n + 1 + j it serves.  The folded form, from the first round after the
    CTA's warm-up on: V, sample n's complete sum with r[n] << sh in it;
    x[n] = the low word of V >> sh; V = C + q[0] * x[n], where C, sample
    n + 1's sum of the older taps and its residual << sh, was made before;
    the older taps' sums D are float64 (exact: every product is below 2^46,
    every sum below 2^51).  Then the epilogue: wasted bits, the stereo
    undo, the range flag, the narrowing."""
    N, C = blocksize, channels
    res = np.asarray(res)[:, :N]
    order = np.asarray(order).astype(np.int64)
    shift = np.asarray(shift).astype(np.int64)
    qlp = np.asarray(qlp)
    S = res.shape[0]
    mo = kernel_order(max_order)
    R = round_len(mo)
    qi = np.zeros((S, mo), np.int64)
    qi[:, :max_order] = qlp[:, :max_order]
    q, qd = qi.view(np.uint64), qi.astype(np.float64)
    r = res.astype(np.int64)
    if not wide:
        r = r.astype(np.int32).astype(np.int64)
    ru = r.view(np.uint64)
    fold = folded_subframes(qi, shift, wide)
    sh_fold = np.where(fold, shift, 0).astype(np.uint64)
    sh_eff = np.where((shift < 0) | (shift >= 64), 63, shift)
    cta = np.arange(S) // SUBS
    P = np.zeros((S, mo), np.uint64)
    # the folded form's state: V, C (int64 bits in uint64) and D
    fp = np.zeros(S, bool)
    V = np.zeros(S, np.uint64)
    Cn = np.zeros(S, np.uint64)
    D = np.zeros((S, mo), np.float64)
    x = np.zeros((S, N), np.int64)

    def rs(n):
        """r[n] << sh of the folding subframes, 0 past N."""
        return ru[:, n] << sh_fold if n < N else np.zeros(S, np.uint64)
    for n0 in range(0, N, R):
        late = np.zeros(cta[-1] + 1 if S else 0, bool)
        np.logical_or.at(late, cta, order > n0)
        warm = late[cta]
        enter = fold & ~warm & ~fp
        if enter.any():
            V[enter] = P[enter, 0]
            Cn[enter] = P[enter, 1] if mo > 1 else 0
            D[enter] = np.where(np.arange(mo) >= 2,
                                P[enter].view(np.int64), 0)
            fp |= enter
        V[fp] += rs(n0)[fp]
        Cn[fp] += rs(n0 + 1)[fp]
        for u in range(min(R, N - n0)):
            n = n0 + u
            # the generic form
            acc = P[:, u % mo].view(np.int64)
            xn = _xt(ru[:, n] + (acc >> sh_eff).view(np.uint64), wide)
            xn = np.where(warm & (n < order), r[:, n], xn)
            # the folded form
            if fp.any():
                xf = (V.view(np.int64) >> sh_fold.view(np.int64)).astype(
                    np.int32).astype(np.int64)
                xn = np.where(fp, xf, xn)
                V = np.where(fp, Cn + q[:, 0] * xf.view(np.uint64), V)
                if mo > 1:
                    for j in range(1, mo):
                        s = (u + 1 + j) % mo
                        D[:, s] = qd[:, j] * xf + (0 if j == mo - 1
                                                   else D[:, s])
                    Cn = D[:, (u + 2) % mo].astype(np.int64).view(np.uint64)
                else:
                    Cn = np.zeros(S, np.uint64)
                if u + 2 < R:
                    Cn = Cn + rs(n + 2)
            P[:, u % mo] = 0
            P[:, (u + 1 + np.arange(mo)) % mo] += q * xn.view(np.uint64)[
                :, None]
            x[:, n] = xn
    bits = 64 if wide else 32
    w = np.asarray(wasted).astype(np.int64)[:, None]
    keep = (w >= 0) & (w < bits)
    y = _xt(np.where(keep, x.view(np.uint64) << (w & (bits - 1)).astype(
        np.uint64), np.uint64(0)), wide).reshape(-1, C, N)
    if C == 2:
        a, b = y[:, 0].view(np.uint64), y[:, 1].view(np.uint64)
        asg = np.asarray(assignment)[:, None]
        mid = (a << np.uint64(1)) | (b & np.uint64(1))
        left = np.where(asg == 2, _xt(b + a, wide),
                        np.where(asg == 3, _xt(mid + b, wide) >> 1,
                                 _xt(a, wide)))
        right = np.where(asg == 1, _xt(a - b, wide),
                         np.where(asg == 3, _xt(mid - b, wide) >> 1,
                                  _xt(b, wide)))
        y = np.stack([left, right], 1)
    oor = np.zeros(y.shape[0], bool)
    if bps:
        lim = 1 << (bps - 1)
        oor = ((y < -lim) | (y >= lim)).reshape(y.shape[0], -1).any(1)
    out_t = np.int16 if out16 else (np.int64 if wide else np.int32)
    return y.astype(out_t), oor


def restore_undo(res, order, shift, qlp, wasted, assignment, *,
                 blocksize: int, channels: int, max_order: int,
                 wide: bool = False, out16: bool = False, bps: int = 0):
    """K3's wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    kw = dict(blocksize=blocksize, channels=channels, max_order=max_order,
              wide=wide, out16=out16, bps=bps)
    if res.device.type == "cpu":
        return bitunpack.restore_undo_body(res, order, shift, qlp, wasted,
                                           assignment, **kw)
    if res.device.type == "cuda":
        return restore_undo_cuda(res, order, shift, qlp, wasted, assignment,
                                 **kw)
    raise ValueError(f"restore_undo: unsupported device {res.device}")
