"""Kernel K5: the frames' CRC-8 and CRC-16 as a hand-written CUDA kernel.

Replaces the CRC stage of flac_tpu/models/frame.py:assemble_frames
(:397-404: crc8_prefix, crc16_words and three deposit_byte calls of
flac_tpu/ops/bitpack.py), which the port ran op by op: a bit-serial GF(2)
fold that reads the whole padded [B, W] word buffer about 130 times, some
1400 small kernels a -5 batch.  The source is csrc/frame_crc.cu: one CTA a
frame.  Thread 0 runs the CRC-8 byte table over the header (at most 15
bytes) and deposits it; then each thread runs the CRC-16 byte table over a
contiguous run of the frame's words, multiplies its remainder by
x^(8 * bytes after the run) mod p (products of `crc.byte_shift_powers`),
and the threads XOR their results; thread 0 deposits both bytes.  The
CRC-16 covers exactly byte_len - 2 bytes, so it needs no padding
correction, and the kernel touches no word outside [0, W).

It seals in place: the words K1 or the safe scatter wrote are the output.

Bound: per -5 batch (B=64 frames of ~9 KB at 44.1 kHz 16-bit stereo) the
kernel must read each frame's bytes once (~0.6 MB) and write 3 bytes a
frame: ~0.2 us of HBM time at 3.35 TB/s (the NVIDIA H100 SXM data sheet's
rate).  One table lookup a byte on 64 CTAs: a launch is latency.
chip_smoke.py measures it.

`frame.seal_frames` dispatches on the tensors' device: the plain version
(frame.seal_frames_plain) for CPU tensors, `seal_frames_cuda` here for
CUDA tensors (it launches or raises; there is no fallback).  `launches`,
`captured` and `count_replay` count launches as pack_cuda's do.  The CRC
tables go to the device once (device.constant), on the first, uncaptured
call of an encode program.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..device import constant
from . import crc

SOURCE = "flac_tpu_torch/csrc/frame_crc.cu"
REPLACES = "flac_tpu/models/frame.py:397"       # the CRC stage
_LIB_NAME = "frame_crc"
POW_TERMS = 32            # byte_shift_powers entries (POW_TERMS in the source)

launches = 0          # kernel launches of K5 in this process
captured = 0          # K5 launches recorded into CUDA graphs (not run)
_lib = None


def tables(device) -> torch.Tensor:
    """[512 + POW_TERMS] int32 on `device`: the CRC-8 byte table, the
    CRC-16 byte table and x^(8 * 2^i) mod the CRC-16 polynomial, copied
    there once."""
    return constant("frame crc tables", device, lambda dev: torch.as_tensor(
        np.concatenate([crc.CRC8_TABLE, crc.CRC16_TABLE,
                        crc.byte_shift_powers(crc.CRC16_POLY, 16,
                                              POW_TERMS)]).astype(np.int32),
        device=dev))


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_frame_crc.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.flac_frame_crc.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_arguments(words, byte_len, hdr_bytes) -> None:
    """Raise ValueError unless words is a contiguous [B, W >= 4] int64
    tensor and byte_len and hdr_bytes are [B] int32 on its device."""
    if words.dtype != torch.int64 or words.ndim != 2 \
            or not words.is_contiguous() or words.shape[1] < 4:
        raise ValueError(f"seal_frames_cuda: words must be a contiguous "
                         f"[B, W >= 4] int64 tensor, not {words.dtype} "
                         f"{tuple(words.shape)}")
    B = words.shape[0]
    for name, t in (("byte_len", byte_len), ("hdr_bytes", hdr_bytes)):
        if t.device != words.device or t.dtype != torch.int32 \
                or tuple(t.shape) != (B,):
            raise ValueError(f"seal_frames_cuda: {name} must be [{B}] int32 "
                             f"on {words.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def seal_frames_cuda(words, byte_len, hdr_bytes):
    """Launch K5 on words [B, W] int64 (contiguous, uint32 words), byte_len
    and hdr_bytes [B] int32, all on one CUDA device.  Seals `words` in
    place and returns it."""
    global launches, captured
    if words.device.type != "cuda":
        raise ValueError("seal_frames_cuda: words are not on a GPU")
    check_arguments(words, byte_len, hdr_bytes)
    B, W = words.shape
    if B == 0:
        return words
    byte_len = byte_len.contiguous()
    hdr_bytes = hdr_bytes.contiguous()
    with torch.cuda.device(words.device):
        tab = tables(words.device)
        lib = _library()
        kernels.check(lib.flac_frame_crc(
            words.data_ptr(), byte_len.data_ptr(), hdr_bytes.data_ptr(),
            tab.data_ptr(), B, W, torch.cuda.current_stream().cuda_stream),
            "flac_frame_crc launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return words


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K5 launches was replayed: they ran."""
    global launches
    launches += n
