"""CRC-8 and CRC-16 for FLAC frames — host and batched-device versions.

The host half (tables, `crc8`, `crc16`, `_xpow_mod_np`) is a copy of
flac_tpu/ops/crc.py.  The batched version uses that CRC over GF(2) is linear
in the message: with zero initial value, crc = (M(x) * x^W) mod p(x), so each
set bit of the message at polynomial degree d contributes the precomputed
constant x^(d+W) mod p — a gather plus an XOR reduction per row, batched
over every frame at once.

Polynomials (reference src/libFLAC/crc.c:32-38):
  CRC-8  : x^8 + x^2 + x^1 + x^0    (0x07),   init 0
  CRC-16 : x^16 + x^15 + x^2 + x^0  (0x8005), init 0
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant
from .bitops import xor_reduce

CRC8_POLY = 0x07
CRC16_POLY = 0x8005


def _poly_for_width(width: int) -> int:
    if width == 8:
        return CRC8_POLY
    if width == 16:
        return CRC16_POLY
    raise ValueError(f"unsupported CRC width {width}")


def _make_byte_table(poly: int, width: int) -> np.ndarray:
    """Standard MSB-first CRC byte table."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
            crc &= mask
        table[b] = crc
    return table


CRC8_TABLE = _make_byte_table(CRC8_POLY, 8)
CRC16_TABLE = _make_byte_table(CRC16_POLY, 16)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def crc8(data) -> int:
    """Host CRC-8 (init 0) over bytes."""
    crc = 0
    for b in _as_u8(data).tolist():
        crc = int(CRC8_TABLE[crc ^ b])
    return crc


def crc16(data) -> int:
    """Host CRC-16 (init 0, poly 0x8005) over bytes."""
    crc = 0
    for b in _as_u8(data).tolist():
        crc = ((crc << 8) & 0xFFFF) ^ int(CRC16_TABLE[(crc >> 8) ^ b])
    return crc


@functools.lru_cache(maxsize=None)
def _xpow_mod_np(poly: int, width: int, max_exp: int):
    """Table P[e] = x^e mod p(x) for e in [0, max_exp), as uint32."""
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    out = np.zeros(max_exp, dtype=np.uint32)
    cur = 1  # x^0
    for e in range(max_exp):
        out[e] = cur
        cur = ((cur << 1) ^ poly) & mask if (cur & top) else (cur << 1) & mask
    return out


def mulmod(a: int, b: int, poly: int, width: int) -> int:
    """(a * b) mod p(x) over GF(2), a and b below 2^width."""
    prod = 0
    for j in range(width):
        if (b >> j) & 1:
            prod ^= a << j
    full = poly | (1 << width)
    for bit in range(2 * width - 2, width - 1, -1):
        if (prod >> bit) & 1:
            prod ^= full << (bit - width)
    return prod


def byte_shift_powers(poly: int, width: int, n: int) -> np.ndarray:
    """[n] uint32: x^(8 * 2^i) mod p(x) for i in [0, n): multiplying a CRC
    remainder by the product of the entries of the set bits of m appends
    m zero bytes to its message."""
    out = np.zeros(n, dtype=np.uint32)
    cur = int(_xpow_mod_np(poly, width, 9)[8])
    for i in range(n):
        out[i] = cur
        cur = mulmod(cur, cur, poly, width)
    return out


def xpow_table(poly: int, width: int, max_exp: int,
               device) -> torch.Tensor:
    """`_xpow_mod_np` as an int64 tensor on `device`, copied there once
    (device.constant; callers must not modify it)."""
    return constant(("crc x^e", poly, width, max_exp), device,
                    lambda dev: torch.as_tensor(
                        _xpow_mod_np(poly, width, max_exp).astype(np.int64),
                        device=dev))


def batched_crc_device(byte_buf, lengths, *, width: int, start=None):
    """Batched CRC over per-row byte ranges of a padded byte buffer.

    byte_buf: [..., max_bytes] uint8 (or any integer dtype holding bytes)
    lengths:  [...] integer — CRC covers bytes [start, length) of each row
    start:    [...] integer or None — optional start offset (default 0)

    Returns [...] int64 CRC values, identical to the reference's sequential
    FLAC__crc8/FLAC__crc16 over the same byte range.

    A byte value b at index i (message length L) occupies polynomial degrees
    8*(L-1-i)+k for each set bit k, contributing P[8*(L-1-i)+k+width].
    """
    max_bytes = byte_buf.shape[-1]
    dev = byte_buf.device
    P = xpow_table(_poly_for_width(width), width, 8 * max_bytes + width + 8,
                   dev)
    buf = byte_buf.to(torch.int64)
    L = lengths.to(torch.int64)[..., None]
    idx = torch.arange(max_bytes, dtype=torch.int64, device=dev)
    dist = L - 1 - idx                      # byte distance from message end
    valid = dist >= 0
    if start is not None:
        valid = valid & (idx >= start.to(torch.int64)[..., None])
    base = torch.where(valid, 8 * dist + width, 0)

    acc = torch.zeros(byte_buf.shape[:-1], dtype=torch.int64, device=dev)
    for k in range(8):
        bit_set = ((buf >> k) & 1).bool() & valid
        contrib = torch.where(bit_set, P[base + k], 0)
        acc = acc ^ xor_reduce(contrib)
    return acc
