"""Kernel K11: the encoder's windowed autocorrelation as a hand-written
CUDA kernel.

Replaces the windows, the autocorrelation and the combine of
flac_tpu/models/subframe.py search_and_realize (:148-156: the windowed
rows float32(x) * windows, flac_tpu/ops/lpc.py:64 autocorrelation and
:109 autocorrelation_mxu, the einsum by the [A, W] combine matrix), which
XLA fuses into the jitted encode_batch and the port ran op by op: a Gram
matmul, then a diagonal, a cast and a sum a lag (some thirty-five small
kernels a -5 batch, fifty at -8).  The source is csrc/window_autoc.cu: a
CTA of 128 threads a (frame, channel candidate) row, a thread a column of
flac_tpu's Gram product (autocorrelation_mxu, blocks of 128 samples);
the row is staged once in shared memory as float32 (a tile of 4096
samples and an O-sample halo, with 16-byte loads), each window's samples
are formed beside it, and a thread's accumulators, one a lag, stay in
registers.  Its arithmetic is ops/lpc.py
autocorrelation_plain's, the plain version, operation for operation
(float32 windowed samples, each column's float32 fused multiply-adds over
its blocks in ascending order, which the plain version emulates exactly,
a fixed float64 tree over the columns, the combine in ascending window
order), so the two agree bit for bit.

Bound: at -5 a batch reads x ([64, 4, 4096] int32, 4.2 MB) once: ~1.3 us
at 3.35 TB/s (the NVIDIA H100 SXM data sheet's rate); at -8 its fmas
bound it (6 windows and 13 lags: 82 M float32 fmas, ~2.4 us at the data
sheet's 67 TFLOP/s of float32 outside the tensor cores).  chip_smoke.py
measures it.

`lpc.window_autocorrelation` dispatches on x's device: the plain version
for CPU tensors, `window_autoc` here for CUDA tensors (it launches or
raises; there is no fallback).  One launch a call.  `launches`,
`captured` and `count_replay` count launches as pack_cuda's do, through
the encoder's CUDA graphs too.  The wrapper allocates its output with
torch and reads nothing back, so it runs inside a capture; the library
loads on a key's first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

SOURCE = "flac_tpu_torch/csrc/window_autoc.cu"
REPLACES = "flac_tpu/ops/lpc.py:64"    # autocorrelation, with the windows
_LIB_NAME = "window_autoc"
THREADS = 128            # threads a CTA (THREADS in the source)
TILE = 4096              # samples a staged tile (TILE in the source)
MAX_LAG = 32             # the largest lag (HALO in the source)
TEMPLATE_LAGS = (8, 12, 32)

launches = 0          # kernel launches of K11 in this process
captured = 0          # K11 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_window_autoc.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flac_window_autoc.restype = ctypes.c_int
        _lib = lib
    return _lib


def template_lag(max_lag: int) -> int:
    """The kernel's template bound that a call with max_lag takes."""
    return next(t for t in TEMPLATE_LAGS if max_lag <= t)


def check_arguments(x, windows, combine, max_lag: int) -> None:
    """Raise ValueError unless x is a [B, CH, N] int32 or int64 tensor,
    windows [W, N] float32, combine [A, W] float64, all on x's device,
    and 1 <= max_lag <= min(32, N - 1)."""
    if x.ndim != 3 or x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"window_autoc: x must be a [B, CH, N] int32 or "
                         f"int64 tensor, not {x.dtype} {tuple(x.shape)}")
    N = x.shape[-1]
    if windows.ndim != 2 or windows.dtype != torch.float32 \
            or windows.shape[1] != N or windows.shape[0] < 1 \
            or windows.device != x.device:
        raise ValueError(f"window_autoc: windows must be [W, {N}] float32 "
                         f"on {x.device}, not {windows.dtype} "
                         f"{tuple(windows.shape)} on {windows.device}")
    if combine.ndim != 2 or combine.dtype != torch.float64 \
            or combine.shape[1] != windows.shape[0] \
            or combine.device != x.device:
        raise ValueError(f"window_autoc: combine must be [A, "
                         f"{windows.shape[0]}] float64 on {x.device}, not "
                         f"{combine.dtype} {tuple(combine.shape)} on "
                         f"{combine.device}")
    if not 1 <= max_lag <= min(MAX_LAG, N - 1):
        raise ValueError(f"window_autoc: max_lag {max_lag} is not in "
                         f"[1, min({MAX_LAG}, N - 1 = {N - 1})]")


def launch_arguments(x, windows, combine, max_lag: int) -> tuple:
    """(the output, allocated on x's device; the C entry point's arguments
    but the stream) of a K11 launch on checked, contiguous arguments."""
    B, CH, N = x.shape
    W, A = windows.shape[0], combine.shape[0]
    out = torch.empty((B, CH, A, max_lag + 1), dtype=torch.float64,
                      device=x.device)
    return out, (x.data_ptr(), windows.data_ptr(), combine.data_ptr(),
                 out.data_ptr(), B * CH, N, W, A, max_lag,
                 int(x.dtype == torch.int64))


def window_autoc(x, windows, combine, max_lag: int) -> torch.Tensor:
    """Launch K11: lpc.window_autocorrelation on a CUDA device.  Returns
    autoc [B, CH, A, max_lag + 1] float64."""
    global launches, captured
    if x.device.type != "cuda":
        raise ValueError("window_autoc: x is not on a GPU")
    check_arguments(x, windows, combine, max_lag)
    x, windows, combine = (t.contiguous() for t in (x, windows, combine))
    out, args = launch_arguments(x, windows, combine, max_lag)
    if x.shape[0] * x.shape[1] == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _library()
        kernels.check(lib.flac_window_autoc(
            *args, torch.cuda.current_stream().cuda_stream),
            "flac_window_autoc launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K11 launches was replayed: they ran."""
    global launches
    launches += n
