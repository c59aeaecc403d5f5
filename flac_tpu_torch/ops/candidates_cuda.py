"""Kernel K10: the encoder's channel candidates and wasted bits as a
hand-written CUDA kernel.

Replaces flac_tpu/models/stereo.py:29-90 (wasted_bits and
build_channel_candidates) with the widening of the uploaded batch to
int32 (flac_tpu/encoder.py:147), and on the loose mid-side path
loose_assignment's sums (stereo.py:93-106), which XLA fuses into the
jitted encode_batch and the port ran op by op: some fifteen small kernels
a batch (the cast, the stack, a tree of ORs, the bit length, the shift).
The source is csrc/channel_candidates.cu: a CTA of 512 threads a frame
(a (frame, channel) where the channels pass through), and two where fewer
frames than SMs would leave SMs idle (-5's 64 frames, not the sharded
form's 256: `split`); each reads the frame's rows in full in the uploaded
type (int16 or int32), 4 samples of a row a load, and ORs each
candidate's samples (a warp reduction, then the warps'), keeps its own
part of the rows (share(N) samples) in shared memory, takes the wasted
bits with __ffs and writes its part of each candidate's shifted samples
with 16-byte stores; no CTA waits on another.  On the loose path the
first CTA of a frame also sums the first differences in int64.
Every quantity is an integer, so the kernel
equals its plain versions (models/stereo.py build_channel_candidates_plain
and loose_assignment) bit for bit.

Bound: at -5 a batch reads [64, 2, 4096] int16 (1.0 MB; int32: 2.1 MB)
and writes [64, 4, 4096] int32 candidates (4.2 MB): ~1.6-1.9 us at 3.35
TB/s (the NVIDIA H100 SXM data sheet's rate).  chip_smoke.py measures it.

`stereo.build_channel_candidates` dispatches on pcm's device: the plain
version for CPU tensors, `channel_candidates` here for CUDA tensors (it
launches or raises; there is no fallback).  One launch a call.
`launches`, `captured` and `count_replay` count launches as pack_cuda's
do, through the encoder's CUDA graphs too.  The wrapper allocates its
outputs with torch and reads nothing back, so it runs inside a capture;
the library loads on a key's first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

SOURCE = "flac_tpu_torch/csrc/channel_candidates.cu"
REPLACES = "flac_tpu/models/stereo.py:41"   # build_channel_candidates, :29-90
_LIB_NAME = "channel_candidates"
THREADS = 512            # threads a CTA (THREADS in the source)
SPLIT = 2                # CTAs a frame with few frames (the source's)
STAGE_BYTES = 40 * 1024  # a part's staged rows at most (the source's)

launches = 0          # kernel launches of K10 in this process
captured = 0          # K10 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_channel_candidates.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.flac_channel_candidates.restype = ctypes.c_int
        _lib = lib
    return _lib


def forms(C: int, cfg) -> tuple:
    """(mid_side, x64, loose): the candidates the configuration asks for
    on C channels, as the plain version decides them, and whether the
    loose assignment comes with them."""
    ms = C == 2 and cfg.do_mid_side
    return ms, ms and cfg.max_subframe_bps > 32, ms and cfg.loose_mid_side


def units(B: int, C: int, cfg) -> int:
    """A launch's units: frames on the mid-side path, else (frame,
    channel)s."""
    return B if forms(C, cfg)[0] else B * C


def split(n_units: int, sms: int) -> int:
    """CTAs a unit on a card of `sms` SMs: SPLIT where one CTA a unit would
    leave SMs idle, else 1 (the source's rule)."""
    return SPLIT if n_units < sms else 1


def share(N: int, parts: int) -> int:
    """The samples of a CTA's part when a unit takes `parts` CTAs (a
    multiple of 8)."""
    return (-(-N // parts) + 7) // 8 * 8


def staged(C: int, N: int, cfg, parts: int) -> bool:
    """Whether a CTA keeps its part of the rows in shared memory (else it
    reads them again for the writes)."""
    return (2 if forms(C, cfg)[0] else 1) * share(N, parts) * 4 \
        <= STAGE_BYTES


def ctas(B: int, C: int, cfg, sms: int) -> int:
    """The launch's grid on a card of `sms` SMs."""
    n = units(B, C, cfg)
    return n * split(n, sms)


def check_arguments(pcm) -> None:
    """Raise ValueError unless pcm is a [B, C, N] int16 or int32 tensor
    with N >= 1."""
    if pcm.ndim != 3 or pcm.dtype not in (torch.int16, torch.int32) \
            or pcm.shape[-1] < 1:
        raise ValueError(f"channel_candidates: pcm must be a [B, C, N] "
                         f"int16 or int32 tensor, not {pcm.dtype} "
                         f"{tuple(pcm.shape)}")


def launch_arguments(pcm, cfg) -> tuple:
    """(the outputs, allocated on pcm's device; the C entry point's
    arguments but the stream) of a K10 launch on checked arguments."""
    B, C, N = pcm.shape
    ms, x64, with_loose = forms(C, cfg)
    CH = 4 if ms else C
    dev = pcm.device
    x = torch.empty((B, CH, N), dtype=torch.int64 if x64 else torch.int32,
                    device=dev)
    bps_eff = torch.empty((B, CH), dtype=torch.int32, device=dev)
    wasted = torch.empty((B, CH), dtype=torch.int32, device=dev)
    out = (x, bps_eff, wasted)
    if with_loose:
        out += (torch.empty((B,), dtype=torch.int32, device=dev),)
    args = (pcm.data_ptr(), x.data_ptr(), bps_eff.data_ptr(),
            wasted.data_ptr(), out[3].data_ptr() if with_loose else None,
            B, C, N, cfg.bits_per_sample, int(pcm.dtype == torch.int16),
            int(ms), int(x64))
    return out, args


def channel_candidates(pcm, cfg) -> tuple:
    """Launch K10: stereo.build_channel_candidates on a CUDA device.
    Returns (x [B, CH, N] int32, int64 on the 33-bit side; bps_eff
    [B, CH] int32; wasted [B, CH] int32), and on the loose mid-side path
    the loose assignment [B] int32 (0 or 3) after them."""
    global launches, captured
    if pcm.device.type != "cuda":
        raise ValueError("channel_candidates: pcm is not on a GPU")
    check_arguments(pcm)
    pcm = pcm.contiguous()
    out, args = launch_arguments(pcm, cfg)
    if pcm.shape[0] * pcm.shape[1] == 0:
        return out
    with torch.cuda.device(pcm.device):
        lib = _library()
        kernels.check(lib.flac_channel_candidates(
            *args, torch.cuda.current_stream().cuda_stream),
            "flac_channel_candidates launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K10 launches was replayed: they ran."""
    global launches
    launches += n
