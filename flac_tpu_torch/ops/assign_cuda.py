"""Kernel K12: the encoder's channel assignment as a hand-written CUDA
kernel.

Replaces flac_tpu/encoder.py:62-80 on the stereo mid-side path:
select_assignment (flac_tpu/models/stereo.py:109), both gather_channels
calls (:134) and the limit_min_bitrate rule, which XLA fuses into the
jitted encode_batch and the port ran op by op: some thirty-five small
kernels a batch (an expand and a gather for each of the 13 SubframeChoice
fields and the signal, the totals, the argmin, the rule's where).  The
source is csrc/assign_channels.cu: a CTA of 256 threads a (frame, output
channel): each thread forms the frame's assignment (the first-index
argmin of the four totals, or the loose assignment K10 computed), thread
0 writes the scalars, and the CTA copies the chosen candidate's small
rows and its residual and signal rows with 16-byte loads and stores.
Every quantity is an integer, so the kernel equals its plain version
(models/stereo.py assign_channels_plain) bit for bit.

Bound: at -5 a batch reads the chosen two of the four residual rows and
signal rows ([64, 2, 4096] int32 each, 4.2 MB) and writes as much: ~2.5
us at 3.35 TB/s (the NVIDIA H100 SXM data sheet's rate).  chip_smoke.py
measures it.

`stereo.assign_channels` dispatches on x's device on the stereo mid-side
path: the plain version for CPU tensors, `assign_channels` here for CUDA
tensors (it launches or raises; there is no fallback).  One launch a
call.  `launches`, `captured` and `count_replay` count launches as
pack_cuda's do, through the encoder's CUDA graphs too.  The wrapper
allocates its outputs with torch and reads nothing back, so it runs
inside a capture; the library loads on a key's first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import format as fmt
from .. import kernels

SOURCE = "flac_tpu_torch/csrc/assign_channels.cu"
REPLACES = "flac_tpu/encoder.py:62"    # the assignment and gathers, :62-80
_LIB_NAME = "assign_channels"
THREADS = 256            # threads a CTA (THREADS in the source)
CANDIDATES = 4           # L, R, M, S
# SubframeChoice's fields (models/subframe.py), in the order the C entry
# point takes them
FIELDS = ("bits", "type_", "order", "wasted", "bps_eff", "qcoeffs", "shift",
          "precision", "warmup", "residual", "po", "params", "use_rice2")

launches = 0          # kernel launches of K12 in this process
captured = 0          # K12 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_assign_channels.argtypes = [ctypes.c_void_p] * 30 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.flac_assign_channels.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_arguments(choice, x, loose) -> None:
    """Raise ValueError unless x is a [B, 4, N] int32 or int64 tensor and
    choice a SubframeChoice of the four candidates on x's device (every
    field int32 but warmup, of x's type, and use_rice2, bool: [B, 4]
    scalars, qcoeffs and warmup [B, 4, 32], residual [B, 4, N] int32,
    params [B, 4, P]), and loose None or a [B] int32 tensor."""
    if x.ndim != 3 or x.dtype not in (torch.int32, torch.int64) \
            or x.shape[1] != CANDIDATES or x.shape[2] < 1:
        raise ValueError(f"assign_channels: x must be a [B, 4, N] int32 or "
                         f"int64 tensor, not {x.dtype} {tuple(x.shape)}")
    B, _, N = x.shape
    P = choice.params.shape[-1] if choice.params.ndim == 3 else 0
    shapes = {"qcoeffs": (B, 4, fmt.MAX_LPC_ORDER),
              "warmup": (B, 4, fmt.MAX_LPC_ORDER), "residual": (B, 4, N),
              "params": (B, 4, P)}
    for name in FIELDS:
        t = getattr(choice, name)
        dtype = {"warmup": x.dtype, "use_rice2": torch.bool}.get(
            name, torch.int32)
        shape = shapes.get(name, (B, 4))
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device:
            raise ValueError(f"assign_channels: {name} must be {list(shape)} "
                             f"{dtype} on {x.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if P < 1:
        raise ValueError("assign_channels: params must have a partition")
    if loose is not None and (loose.dtype != torch.int32
                              or tuple(loose.shape) != (B,)
                              or loose.device != x.device):
        raise ValueError(f"assign_channels: loose must be [{B}] int32 on "
                         f"{x.device}, not {loose.dtype} "
                         f"{tuple(loose.shape)} on {loose.device}")


def launch_arguments(choice, x, loose, limit_min_bitrate: bool) -> tuple:
    """(the outputs, allocated on x's device; the C entry point's
    arguments but the stream) of a K12 launch on checked arguments; the
    inputs are made contiguous and kept in the arguments' tuple."""
    B, _, N = x.shape
    dev = x.device
    inputs = [getattr(choice, f).contiguous() for f in FIELDS] + [
        x.contiguous(), None if loose is None else loose.contiguous()]
    outputs = [torch.empty((B, 2) + tuple(t.shape[2:]), dtype=t.dtype,
                           device=dev) for t in inputs[:len(FIELDS)]]
    out = (torch.empty((B,), dtype=torch.int32, device=dev), *outputs,
           torch.empty((B, 2, N), dtype=x.dtype, device=dev))
    args = (*(None if t is None else t.data_ptr() for t in inputs),
            *(t.data_ptr() for t in out), B, N, choice.params.shape[-1],
            int(x.dtype == torch.int64), int(limit_min_bitrate))
    return out, args, inputs


def assign_channels(choice, x, loose, limit_min_bitrate: bool) -> tuple:
    """Launch K12: stereo.assign_channels on a CUDA device, on the stereo
    mid-side path.  Returns (assignment [B] int32, the 13 SubframeChoice
    fields of the two stream channels in FIELDS order, signal [B, 2, N])."""
    global launches, captured
    if x.device.type != "cuda":
        raise ValueError("assign_channels: x is not on a GPU")
    check_arguments(choice, x, loose)
    out, args, _inputs = launch_arguments(choice, x, loose,
                                          limit_min_bitrate)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _library()
        kernels.check(lib.flac_assign_channels(
            *args, torch.cuda.current_stream().cuda_stream),
            "flac_assign_channels launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K12 launches was replayed: they ran."""
    global launches
    launches += n
