"""Kernel K5: the frames' CRC-8 and CRC-16 as a hand-written CUDA kernel.

Replaces the CRC stage of flac_tpu/models/frame.py:assemble_frames
(:397-404: crc8_prefix, crc16_words and three deposit_byte calls of
flac_tpu/ops/bitpack.py), which the port ran op by op: a bit-serial GF(2)
fold that reads the whole padded [B, W] word buffer about 130 times, some
1400 small kernels a -5 batch.  The source is csrc/frame_crc.cu: a thread
block cluster of up to CLUSTER CTAs a frame (`cluster_size`).  The
frame's whole 8-byte pairs under the CRC-16 are read end-aligned (leading
zero bytes leave a CRC with init 0 unchanged), a column of pairs a
thread, 16 bytes a load; a pair's CRC comes from the slicing tables, a
column folds its pairs by Horner and the columns fold by a tree, each
step a multiply by a constant power of x done as two lookups in the
tables of `level_tables`; the ranks meet in rank 0's shared memory.  The
warp that reads the CRC-8 byte computes the CRC-8 (`p8_table`) and folds
the deposited word in; rank 0's thread 0 adds the last partial pair and
writes the three deposits.  The CRC-16 covers exactly byte_len - 2 bytes,
so it needs no padding correction, and the kernel touches no word
outside [0, W).

It seals in place: the words K1 or the safe scatter wrote are the output.

Bound: per -5 batch (B=64 frames of ~9 KB at 44.1 kHz 16-bit stereo) the
kernel must read each frame's bytes once (~0.6 MB) and write 3 bytes a
frame: ~0.2 us of HBM time at 3.35 TB/s (the NVIDIA H100 SXM data sheet's
rate), below the device time of an empty launch.  chip_smoke.py measures
it beside one.

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
LEVELS = 12               # level_tables' powers x^(64 * 2^l) (LEVELS)
P8_LEN = 127              # the order of x mod the CRC-8 polynomial (P8_LEN)
CLUSTER = 8               # the most CTAs a frame (CLUSTER in the source)
CTA_TARGET = 132          # CTAs a launch it fills before halving (CTA_TARGET)

launches = 0          # kernel launches of K5 in this process
captured = 0          # K5 launches recorded into CUDA graphs (not run)
_lib = None


def slicing_tables() -> np.ndarray:
    """[8, 256] uint16: T_i[b] = b(x) x^(16 + 8i) mod the CRC-16
    polynomial, the CRC-16 of byte b followed by i zero bytes (T_0 is the
    byte table)."""
    xp = crc._xpow_mod_np(crc.CRC16_POLY, 16, 64)
    return np.array([[crc.mulmod(int(v), int(xp[8 * i]), crc.CRC16_POLY, 16)
                      for v in crc.CRC16_TABLE] for i in range(8)],
                    np.uint16)


def level_tables() -> np.ndarray:
    """[LEVELS, 2, 256] uint16: r x^(64 * 2^l) mod the CRC-16 polynomial
    for r = v (row 0) and r = v << 8 (row 1), so that a remainder r times
    that power is row0[r & 0xFF] ^ row1[r >> 8]: appending 8 * 2^l zero
    bytes to its message."""
    out = np.zeros((LEVELS, 2, 256), np.uint16)
    power = int(crc.byte_shift_powers(crc.CRC16_POLY, 16, 4)[3])  # x^64
    for lv in range(LEVELS):
        for v in range(256):
            out[lv, 0, v] = crc.mulmod(v, power, crc.CRC16_POLY, 16)
            out[lv, 1, v] = crc.mulmod(v << 8, power, crc.CRC16_POLY, 16)
        power = crc.mulmod(power, power, crc.CRC16_POLY, 16)
    return out


def p8_table() -> np.ndarray:
    """[128] uint8: x^e mod the CRC-8 polynomial for e < P8_LEN (x has
    that order, so x^e is entry e mod P8_LEN), then a zero: bit k of byte
    i of an h-byte header adds entry (8 (h - 1 - i) + 8 + k) mod P8_LEN to
    its CRC-8."""
    out = np.zeros(128, np.uint8)
    out[:P8_LEN] = crc._xpow_mod_np(crc.CRC8_POLY, 8, P8_LEN)
    return out


def host_tables() -> np.ndarray:
    """The int32 table the kernel reads: the CRC-8 byte table, the CRC-16
    byte table, x^(8 * 2^i) mod the CRC-16 polynomial (POW_TERMS of them),
    then the image the kernel copies into shared memory (slicing_tables,
    p8_table, level_tables, packed two uint16 or four bytes an entry)."""
    image = np.concatenate([slicing_tables().view(np.uint8).ravel(),
                            p8_table(),
                            level_tables().view(np.uint8).ravel()])
    return np.concatenate([
        np.concatenate([crc.CRC8_TABLE, crc.CRC16_TABLE,
                        crc.byte_shift_powers(crc.CRC16_POLY, 16,
                                              POW_TERMS)]).astype(np.int32),
        image.view("<i4")])


def tables(device) -> torch.Tensor:
    """host_tables as an int32 tensor on `device`, copied there once."""
    return constant("frame crc tables", device,
                    lambda dev: torch.as_tensor(host_tables(), device=dev))


def cluster_size(B: int) -> int:
    """K5's CTAs a frame at a batch of B frames: CLUSTER, halved while
    B times it passes CTA_TARGET (the source's rule)."""
    nc = CLUSTER
    while nc > 1 and B * nc > CTA_TARGET:
        nc >>= 1
    return nc


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
