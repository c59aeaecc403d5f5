"""Host-side bit utilities: UTF-8-style number coding and a small BitWriter.

The hot bit-packing path runs on TPU (flac_tpu.ops.bitpack); this module
serves the host-side cold path — metadata blocks, STREAMINFO, stream
assembly — mirroring the semantics of the reference bitwriter
(src/libFLAC/bitwriter.c:357-935) without its word-buffer machinery.
"""

from __future__ import annotations


def utf8_encode_int(val: int) -> bytes:
    """FLAC's extended UTF-8-style coding of frame/sample numbers.

    Like UTF-8 but extended to 36-bit values (7-byte form)
    (reference src/libFLAC/bitwriter.c:832-930).
    """
    if val < 0x80:
        return bytes([val])
    if val < 0x800:
        return bytes([0xC0 | (val >> 6), 0x80 | (val & 0x3F)])
    if val < 0x10000:
        return bytes([0xE0 | (val >> 12), 0x80 | ((val >> 6) & 0x3F),
                      0x80 | (val & 0x3F)])
    if val < 0x200000:
        return bytes([0xF0 | (val >> 18), 0x80 | ((val >> 12) & 0x3F),
                      0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if val < 0x4000000:
        return bytes([0xF8 | (val >> 24), 0x80 | ((val >> 18) & 0x3F),
                      0x80 | ((val >> 12) & 0x3F), 0x80 | ((val >> 6) & 0x3F),
                      0x80 | (val & 0x3F)])
    if val < 0x80000000:
        return bytes([0xFC | (val >> 30), 0x80 | ((val >> 24) & 0x3F),
                      0x80 | ((val >> 18) & 0x3F), 0x80 | ((val >> 12) & 0x3F),
                      0x80 | ((val >> 6) & 0x3F), 0x80 | (val & 0x3F)])
    if val < 0x1000000000:  # 36-bit max
        return bytes([0xFE, 0x80 | ((val >> 30) & 0x3F),
                      0x80 | ((val >> 24) & 0x3F), 0x80 | ((val >> 18) & 0x3F),
                      0x80 | ((val >> 12) & 0x3F), 0x80 | ((val >> 6) & 0x3F),
                      0x80 | (val & 0x3F)])
    raise ValueError(f"value {val} too large for FLAC UTF-8 coding")


def utf8_encoded_len(val: int) -> int:
    return len(utf8_encode_int(val))


def utf8_decode_int(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Decode one UTF-8-style number; returns (value, bytes_consumed).

    Raises ValueError on malformed sequences (mirrors the reference
    bitreader returning 0xFFFFFFFF..., src/libFLAC/bitreader.c:928-1038).
    """
    b0 = data[pos]
    if b0 < 0x80:
        return b0, 1
    n = 0
    for n_try, mask, prefix in ((1, 0xE0, 0xC0), (2, 0xF0, 0xE0),
                                (3, 0xF8, 0xF0), (4, 0xFC, 0xF8),
                                (5, 0xFE, 0xFC), (6, 0xFF, 0xFE)):
        if (b0 & mask) == prefix:
            n = n_try
            val = b0 & (~mask & 0xFF)
            break
    else:
        raise ValueError(f"malformed UTF-8 lead byte 0x{b0:02x}")
    for i in range(1, n + 1):
        b = data[pos + i]
        if (b & 0xC0) != 0x80:
            raise ValueError("malformed UTF-8 continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val, n + 1


class BitWriter:
    """Minimal MSB-first bit accumulator for host-side (cold-path) packing."""

    def __init__(self) -> None:
        self._acc = 0       # pending bits, MSB-first in the low `._n` bits
        self._n = 0
        self._out = bytearray()

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        assert 0 <= value < (1 << bits), (value, bits)
        self._acc = (self._acc << bits) | value
        self._n += bits
        while self._n >= 8:
            self._n -= 8
            self._out.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_signed(self, value: int, bits: int) -> None:
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, value: int) -> None:
        """`value` zero bits followed by a one bit."""
        self.write(1, value + 1)

    def write_bytes(self, data: bytes) -> None:
        if self._n == 0:
            self._out.extend(data)
        else:
            for b in data:
                self.write(b, 8)

    def pad_to_byte(self) -> None:
        if self._n:
            self.write(0, 8 - self._n)

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._n

    def getvalue(self) -> bytes:
        assert self._n == 0, "unaligned bitwriter"
        return bytes(self._out)


class BitReader:
    """Minimal MSB-first bit reader for host-side parsing (metadata, tests)."""

    def __init__(self, data: bytes, bitpos: int = 0) -> None:
        self.data = data
        self.pos = bitpos

    def read(self, bits: int) -> int:
        val = 0
        pos = self.pos
        for _ in range(bits):
            byte = self.data[pos >> 3]
            val = (val << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return val

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        if v >= (1 << (bits - 1)):
            v -= 1 << bits
        return v

    def read_unary(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n

    def align_to_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7
