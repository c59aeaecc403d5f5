"""Vectorized bitstream packer: a batch of FLAC frames packed in parallel.

Port of flac_tpu/ops/bitpack.py (the reference's sequential BitWriter,
src/libFLAC/bitwriter.c, recast): a frame is a fixed-shape list of
*fields* — each field emits `nzeros` zero bits followed by a `pbits`-bit
payload (Rice codes are exactly this shape: q unary zeros, then the stop
bit + k LSBs as a (k+1)-bit payload).  Packing is then:

  1. exclusive cumsum of field bit-lengths -> absolute bit offsets
  2. each payload spans at most two (three for 64-bit payloads) 32-bit
     words -> scatter-adds into a zeroed word buffer (disjoint bit ranges
     make add == or)
  3. CRC-8/CRC-16 computed on the device and OR-deposited into their slots

Words are uint32 values carried in int64 in [0, 2^32).  Out-of-range word
indices are dropped, as the reference's `mode="drop"` scatters do (negative
indices wrap once first, as JAX index normalization does).

ops/pack_cuda.py holds the CUDA kernel that replaces `pack_fields64` on the
GPU; `pack_fields64` here is its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant
from .bitops import srl64, xor_reduce
from .crc import CRC8_POLY, CRC16_POLY, _xpow_mod_np, mulmod, xpow_table

U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Field packing
# ---------------------------------------------------------------------------

def _scatter_add_drop(words, idx, val):
    """words[b, idx[b, s]] += val[b, s], dropping indices outside [0, W)
    after one negative wrap (the reference scatter's semantics)."""
    W = words.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + W, idx)
    keep = (idx >= 0) & (idx < W)
    words.scatter_add_(1, torch.where(keep, idx, 0), torch.where(keep, val, 0))


def _field_word_contribs(nzeros, payload, pbits):
    """Shared front half of the 32-bit packers: per-field word index + the
    two word-aligned contribution planes (a payload spans at most two
    words).  payload: uint32 values in int64."""
    nbits = nzeros + pbits
    end = torch.cumsum(nbits, dim=1, dtype=torch.int32)
    total_bits = end[:, -1]
    pos = end - pbits                    # payload start bit offset

    w = pos >> 5
    sh = pos & 31
    t = (sh + pbits).to(torch.int64)     # in 1..63 for pbits>=1
    pay = payload.to(torch.int64) & U32
    use = pbits > 0
    hi = torch.where(t <= 32, (pay << torch.clamp(32 - t, 0, 31)) & U32,
                     pay >> torch.clamp(t - 32, 0, 31))
    lo = torch.where(t <= 32, 0, (pay << torch.clamp(64 - t, 0, 31)) & U32)
    hi = torch.where(use, hi, 0)
    lo = torch.where(use, lo, 0)
    return w, hi, lo, total_bits


def pack_fields(nzeros, payload, pbits, max_words: int):
    """Pack per-frame field lists into big-endian 32-bit word buffers.

    nzeros:  [B, S] int32  — leading zero bits per field
    payload: [B, S] int64  — payload bits (LSB-aligned), 0 <= pbits <= 32
    pbits:   [B, S] int32  — payload bit count (0 = no payload)

    Returns (words [B, max_words] int64 holding uint32, total_bits [B]
    int32).  Fields must already include any byte-alignment padding.
    """
    B, S = nzeros.shape
    w, hi, lo, total_bits = _field_word_contribs(nzeros, payload, pbits)
    words = torch.zeros((B, max_words), dtype=torch.int64,
                        device=nzeros.device)
    _scatter_add_drop(words, w, hi)
    _scatter_add_drop(words, w + 1, lo)
    return words & U32, total_bits


def _field_contribs64(nzeros, payload64, pbits):
    """Per-field word index + the three word-aligned contribution planes of
    a <=63-bit payload (int64 holding the uint64 bit pattern)."""
    nbits = nzeros + pbits
    end = torch.cumsum(nbits, dim=1, dtype=torch.int32)
    total_bits = end[:, -1]
    pos = end - pbits
    w = pos >> 5
    sh = pos & 31
    t = (sh + pbits).to(torch.int64)      # field end within 3-word window
    pay = payload64.to(torch.int64)
    cs = []
    for j in range(3):
        d = 32 * (j + 1) - t              # left-shift amount into word j
        contrib = torch.where(
            d >= 0,
            torch.where(d >= 64, 0, pay << torch.clamp(d, 0, 63)),
            srl64(pay, torch.clamp(-d, 0, 63))) & U32
        cs.append(torch.where(pbits > 0, contrib, 0))
    return w, cs, total_bits


def pack_fields64(nzeros, payload64, pbits, max_words: int):
    """64-bit-payload packer: like pack_fields but payloads up to 63 bits
    (a fused run of up to four Rice codes — see models/frame.py's quad
    layout).  A payload spans at most three words -> three scatter-adds.

    nzeros:    [B, S] int32
    payload64: [B, S] int64 (LSB-aligned uint64 bit pattern)
    pbits:     [B, S] int32 in [0, 63]
    Returns (words [B, max_words] int64 holding uint32, total_bits [B]
    int32).  This is the plain version of kernel K1 (ops/pack_cuda.py).
    """
    B, S = nzeros.shape
    w, cs, total_bits = _field_contribs64(nzeros, payload64, pbits)
    words = torch.zeros((B, max_words), dtype=torch.int64,
                        device=nzeros.device)
    for j in range(3):
        _scatter_add_drop(words, w + j, cs[j])
    return words & U32, total_bits


def words_to_bytes(words):
    """[..., W] big-endian uint32 words (in int64) -> [..., 4W] uint8."""
    parts = [((words >> s) & 0xFF).to(torch.uint8) for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).reshape(
        words.shape[:-1] + (words.shape[-1] * 4,))


# ---------------------------------------------------------------------------
# CRC on packed words — log-depth GF(2) tree fold
# ---------------------------------------------------------------------------
#
# crc(M) = M(x) * x^W mod p.  The word buffer folds pairwise: at level l
# each left half is multiplied by the constant x^(bits of right half) mod p
# and XORed with the right half.  The constant is fixed per level, so the
# carry-less multiply unrolls to a handful of masked XOR-shifts.  Per-frame
# byte lengths are fixed up at the end by one multiply with x^(-8*pad) mod p
# from a precomputed table.


def _clmul_const_mod(a, const: int, poly_full: int, width: int):
    """a: [...] int64 (width-bit values). Returns (a * const) mod p."""
    prod = torch.zeros_like(a)
    for j in range(width):
        if (const >> j) & 1:
            prod = prod ^ (a << j)
    # reduce bits [2*width-2 .. width] down
    for bit in range(2 * width - 2, width - 1, -1):
        mask = (prod >> bit) & 1
        prod = prod ^ ((poly_full << (bit - width)) * mask)
    return prod


def _clmul_var_mod(a, b, poly_full: int, width: int):
    """(a * b) mod p for variable width-bit operands (tensors)."""
    prod = torch.zeros_like(a)
    for j in range(width):
        bit = (b >> j) & 1
        prod = prod ^ ((a << j) * bit)
    for bit in range(2 * width - 2, width - 1, -1):
        mask = (prod >> bit) & 1
        prod = prod ^ ((poly_full << (bit - width)) * mask)
    return prod


@functools.lru_cache(maxsize=None)
def _xpow(poly: int, width: int, exp: int) -> int:
    """x^exp mod p as a host int (exp >= 0)."""
    table = _xpow_mod_np(poly, width, exp + 1)
    return int(table[exp])


@functools.lru_cache(maxsize=None)
def _inv_x8_powers(poly: int, width: int, max_pad: int) -> np.ndarray:
    """Table of x^(-8j) mod p for j in [0, max_pad]."""
    # x^-1 = (p(x) + 1)/x, because x * ((p+1)/x) = p+1 = 1 mod p
    inv_x = (poly | (1 << width)) ^ 1  # p_full - 1 (clear constant term)
    inv_x >>= 1                        # divide by x (exact)
    inv_x8 = 1
    for _ in range(8):
        inv_x8 = mulmod(inv_x8, inv_x, poly, width)
    out = np.zeros(max_pad + 1, dtype=np.int64)
    cur = 1
    for j in range(max_pad + 1):
        out[j] = cur
        cur = mulmod(cur, inv_x8, poly, width)
    return out


def crc16_words(words, byte_lengths):
    """CRC-16 (poly 0x8005, init 0) over the first `byte_lengths` bytes of
    big-endian word buffers.

    words: [B, W] int64 holding uint32, W a power of two; bytes beyond
           byte_lengths must be zero.
    byte_lengths: [B] integer
    Returns [B] int64.
    """
    poly_full = (1 << 16) | CRC16_POLY
    W = words.shape[-1]
    assert W & (W - 1) == 0, "word count must be a power of two"

    # initial per-word contribution: word w (32 bits) at its own scale:
    # contribution = w(x) * x^16 mod p, where w's bit k has degree k
    acc = torch.zeros_like(words)
    for k in range(32):
        const = _xpow(CRC16_POLY, 16, 16 + k)
        acc = acc ^ (const * ((words >> k) & 1))

    # tree fold: combine adjacent (left, right): left * x^(bits right) ^ right
    level_bytes = 4
    while acc.shape[-1] > 1:
        left = acc[..., 0::2]
        right = acc[..., 1::2]
        c = _xpow(CRC16_POLY, 16, 8 * level_bytes)
        acc = _clmul_const_mod(left, c, poly_full, 16) ^ right
        level_bytes *= 2
    crc_full = acc[..., 0]

    # strip the zero padding: crc_true = crc_full * x^(-8*pad) mod p
    pad = (4 * W) - byte_lengths.to(torch.int64)
    inv_tab = constant(("crc16 x^-8j", W), words.device,
                       lambda dev: torch.as_tensor(
                           _inv_x8_powers(CRC16_POLY, 16, 4 * W), device=dev))
    return _clmul_var_mod(crc_full, inv_tab[pad], poly_full, 16)


def crc8_prefix(byte_buf, prefix_lengths, max_prefix: int):
    """CRC-8 over the first `prefix_lengths` bytes (frame header CRC).

    byte_buf: [B, >=max_prefix] uint8; prefix_lengths: [B] integer
    (<= max_prefix).  Direct contribution sum — the prefix is tiny.
    Returns [B] int64.
    """
    P = xpow_table(CRC8_POLY, 8, 8 * max_prefix + 16, byte_buf.device)
    buf = byte_buf[..., :max_prefix].to(torch.int64)
    idx = torch.arange(max_prefix, dtype=torch.int64, device=byte_buf.device)
    dist = prefix_lengths.to(torch.int64)[..., None] - 1 - idx
    valid = dist >= 0
    base = torch.where(valid, 8 * dist + 8, 0)
    acc = torch.zeros(byte_buf.shape[:-1], dtype=torch.int64,
                      device=byte_buf.device)
    for k in range(8):
        bit_set = ((buf >> k) & 1).bool() & valid
        contrib = torch.where(bit_set, P[base + k], 0)
        acc = acc ^ xor_reduce(contrib)
    return acc


def deposit_byte(words, byte_index, value):
    """OR an 8-bit value into big-endian word buffers at a byte position.

    words: [B, W] int64 holding uint32; byte_index: [B] integer; value: [B]
    integer < 256.  The target byte must currently be zero.  Returns a new
    tensor (the input is not modified).
    """
    byte_index = byte_index.to(torch.int64)
    w = byte_index >> 2
    sh = (3 - (byte_index & 3)) * 8
    contrib = (value.to(torch.int64) << sh) & U32
    out = words.clone()
    _scatter_add_drop(out, w[:, None], contrib[:, None])
    return out & U32
