"""Kernel K3: the LPC restore, wasted-bit shift and stereo undo of the
decoders, hand-written CUDA.

Replaces flac_tpu/ops/bitunpack.py:53-120, restore_undo_body: an XLA
lax.scan that both the device engine (after the code scan, K2) and the
"fast" engine (after the native full parse) run as one compiled program.
Its plain version is the port's `bitunpack.restore_undo_body`, an eager
loop of about six launches a sample step.  The source is csrc/restore.cu,
designed for Hopper: one thread a subframe (the recursion is serial and
non-linear), taps and history in registers through a template on the order
bucket, a frame's channels in adjacent lanes of one warp so that the stereo
undo is a shuffle, 16-byte loads and stores where rows are aligned.

Bound: a full -5 batch (1024 stereo frames of 4096 samples) reads res once
(33.5 MB in int32) and writes pcm once (16.8 MB in int16): ~0.015 ms at
3.35 TB/s.  With 2048 subframes, about 16 warps on 132 SMs, the kernel is
latency-bound: each thread's serial chain of 4096 samples sets its time.
chip_smoke.py reckons the bound of the batch it times.

`restore_undo` dispatches on the tensors' device: the plain version for
CPU tensors, the kernel for CUDA tensors (it launches or raises; there is no
fallback).  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import bitunpack

SOURCE = "flac_tpu_torch/csrc/restore.cu"
REPLACES = "flac_tpu/ops/bitunpack.py:53"     # restore_undo_body
LIB_NAME = "restore"
ORDER_BUCKETS = (1, 2, 4, 8, 12, 16, 32)      # the kernel's templates
GROUP = 8             # samples a load/store group (GROUP in the source)
THREADS = 32          # subframes a CTA (THREADS in the source)

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
    vec_in = (N % GROUP == 0 and _aligned16(res)
              and res.stride(0) * rbytes % 16 == 0)
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
