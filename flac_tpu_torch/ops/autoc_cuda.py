"""Kernel K11: the encoder's windowed autocorrelation as a hand-written
CUDA kernel.

Replaces the windows, the autocorrelation and the combine of
flac_tpu/models/subframe.py search_and_realize (:148-156: the windowed
rows float32(x) * windows, flac_tpu/ops/lpc.py:64 autocorrelation and
:109 autocorrelation_mxu, the einsum by the [A, W] combine matrix), which
XLA fuses into the jitted encode_batch and the port ran op by op: a Gram
matmul, then a diagonal, a cast and a sum a lag (some thirty-five small
kernels a -5 batch, fifty at -8).  The source is csrc/window_autoc.cu.
With several windows (-6 to -8) a CTA of 384 threads takes two (frame,
channel candidate) rows (the windows are read once for both) and a pass
of up to 6 windows; each
(row, window) pair's windowed samples are staged in shared memory a tile
of 4096 samples and a 32-sample halo at a time (the windows by cp.async,
every copy in flight at once, the rows by 16-byte loads meanwhile), each
block of 128 flagged when its first factors are not all zero.  A warp then
takes a (row, window, lag part): lane j the four consecutive columns
4j..4j+3 of flac_tpu's Gram product (autocorrelation_mxu, blocks of 128)
for each lag of its part, so one warp covers a block; 16-byte shared
loads, only the flagged blocks (a skipped block adds an exact zero), a
float64 reduce-scatter of shuffles in the plain version's tree order, the
combine in ascending window order.  With one window (-3 to -5) that
layout leaves a lone computing warp a row, so a CTA of 128 threads takes
one row, a thread a column: the row and the window loaded at once, their
products into shared memory, 4-byte shared loads (a tile whose windowed
samples are all zero skipped).  Its arithmetic is ops/lpc.py
autocorrelation_plain's, the plain version, operation for operation
(float32 windowed samples, each column's float32 fused multiply-adds over
its blocks in ascending order, which the plain version emulates exactly,
a fixed float64 tree over the columns, the combine in ascending window
order), so the two agree bit for bit (a skipped block's zeros aside,
which can change only the sign of a column sum that is zero).

Bound: at -5 a batch reads x ([64, 4, 4096] int32, 4.2 MB) once: ~1.3 us
at 3.35 TB/s (the NVIDIA H100 SXM data sheet's rate); at -8 its fmas
bound it (6 windows and 13 lags: 82 M float32 fmas, ~2.4 us at the data
sheet's 67 TFLOP/s of float32 outside the tensor cores; about half of
them fall in blocks whose windowed samples are all zero, which no exact
implementation needs to compute).  chip_smoke.py
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
COLUMNS_A_LANE = 4       # consecutive Gram columns a lane (COLS)
LANES = 32               # lanes a warp: a warp covers a Gram block
THREADS = 384            # threads a CTA (THREADS in the source)
ONE_THREADS = 128        # threads a CTA with one window (ONE_THREADS)
TILE = 4096              # samples a staged tile (TILE in the source)
MAX_LAG = 32             # the largest lag (HALO in the source)
MAX_ROWS = 2             # rows a CTA (MAX_ROWS in the source)
WPASS = 6                # windows a pass, at most (WPASS in the source)
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


def part_lags(max_lag: int) -> int:
    """The lags a warp takes under the template that max_lag takes
    (part_lags in the source): all of them up to 13, else parts of 12."""
    t = template_lag(max_lag)
    return t + 1 if t <= 12 else 12


def plan(R: int, W: int, max_lag: int) -> dict:
    """The launch's layout, as flac_window_autoc chooses it: threads and
    rows a CTA, windows a pass, lag parts a window and the CTAs (one
    window: a CTA of ONE_THREADS a row)."""
    if W == 1:
        return {"threads": ONE_THREADS, "rows": 1, "wpass": 1, "parts": 1,
                "ctas": R}
    lp = part_lags(max_lag)
    parts = -(-(max_lag + 1) // lp)
    wpass = min(W, WPASS)
    while MAX_ROWS * wpass * parts > THREADS // 32:
        wpass -= 1
    return {"threads": THREADS, "rows": MAX_ROWS, "wpass": wpass,
            "parts": parts, "ctas": -(-R // MAX_ROWS)}


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
