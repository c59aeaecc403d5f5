"""Synthetic batches for kernels K4 (the field lists, csrc/assemble_fields.cu)
and K5 (the CRC seal, csrc/frame_crc.cu), made from a seed with numpy.

Each pins a corner of models/frame.py's assemble_fields_plain that the
encoder's real batches rarely reach: CONSTANT, VERBATIM, FIXED and LPC
subframes side by side, wasted bits, escaped partitions (raw widths 0 and
31), RICE2 parameters, every partition order up to the maximum (and an N
that skips the orders whose partitions do not divide it, so the plain
version's first match keeps partition 0's parameter), quad misfits, a
blocksize and a rate with 16-bit header tails, 8-bit ones, 7-byte UTF-8
frame numbers, mono and 8 channels, the 33-bit side's (high, low-16)
pairs, with int64 signals, in the wide layout and under an explicit quad
layout, and the edges of K4's cluster of CTAs a frame: a batch of one
frame, 133 frames (more clusters than the H100's 132 SMs), 16-sample
frames, whose few field slots leave the last ranks of a cluster none,
36-sample frames whose partitions of 9 and 18 samples put a quad's four
samples in two partitions, minimal frames (a 5-byte header, a CONSTANT
8-bit mono subframe: 10 bytes) and 256 frames (K5's launch of one CTA a
frame).  A case's subframe choice is random but keeps each frame within
the word rows (residuals near their partition's Rice parameter), so the
whole chain fields -> pack -> seal runs on it too.

`seal_cases` are K5's own corners, packed words made up directly:
byte_len - 2 at every residue mod 16, the longest header (15 bytes
before the CRC-8), minimal frames, a CRC-8 byte whose word is not zero
(the deposit carries), a batch of one 10 KB frame, 64 and 256 frames,
and, past the plain version's domain (`seal_host` is the reference
there), byte_len - 2 past the row (those bytes count as zeros), byte_len
of 0, 1 and 2 (L < 0 counts as 0) and rows of an odd W.

chip_smoke.py and the card-only tests hold K4 and K5 against their plain
versions on them; the CPU tests hold the plain seal against the host CRC.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..config import EncoderConfig
from ..models.subframe import SubframeChoice
from . import crc
from .rice import ESCAPE_K_BASE

TYPES = (fmt.SUBFRAME_TYPE_CONSTANT, fmt.SUBFRAME_TYPE_VERBATIM,
         fmt.SUBFRAME_TYPE_FIXED, fmt.SUBFRAME_TYPE_LPC)


def batch(seed: int, *, B: int, C: int, N: int, P: int, bps: int,
          sample_rate: int = 44100, first_frame: int = 0,
          layout: str = "auto", types=TYPES, wasted_max: int = 3,
          escape: float = 0.1, rice2: float = 0.3, big_q: float = 0.0,
          wide: bool = False) -> dict:
    """One batch: the subframe choice as numpy arrays, the signal, the
    assignment, the frame numbers and the encoder's arguments.

    big_q: the share of partitions whose residuals run far past their
    parameter (long unary runs: quad misfits).  wide: the 33-bit side
    configuration (bps 32 stereo with mid-side; int64 signal and warm-up,
    the side channel up to 33 bits).
    """
    rng = np.random.default_rng(seed)
    max_po = P.bit_length() - 1
    shape = (B, C)
    type_ = rng.choice(np.asarray(types, np.int32), shape).astype(np.int32)
    wasted = rng.integers(0, wasted_max + 1, shape).astype(np.int32)
    assignment = (rng.integers(0, 4, B) if C == 2
                  else np.zeros(B, np.int64)).astype(np.int32)
    bps_eff = np.full(shape, bps, np.int32)
    if C == 2:
        # the side channel of an assignment carries one more bit
        side = np.where(assignment == 1, 1, np.where(assignment == 2, 0, 1))
        bps_eff[np.arange(B), side] += (assignment != 0).astype(np.int32)
    bps_eff -= np.minimum(wasted, bps_eff - 1)
    order = np.zeros(shape, np.int32)
    is_f = type_ == fmt.SUBFRAME_TYPE_FIXED
    is_l = type_ == fmt.SUBFRAME_TYPE_LPC
    order[is_f] = rng.integers(0, fmt.MAX_FIXED_ORDER + 1, int(is_f.sum()))
    order[is_l] = rng.integers(1, fmt.MAX_LPC_ORDER + 1, int(is_l.sum()))
    # precision and shift of every type: the plain version writes their
    # payloads whatever the type
    precision = rng.integers(0, fmt.MAX_QLP_COEFF_PRECISION + 1,
                             shape).astype(np.int32)
    precision[is_l] = rng.integers(fmt.MIN_QLP_COEFF_PRECISION,
                                   fmt.MAX_QLP_COEFF_PRECISION + 1,
                                   int(is_l.sum()))
    shift = rng.integers(0, 16, shape).astype(np.int32)
    qcoeffs = rng.integers(-(1 << 15), 1 << 15,
                           shape + (fmt.MAX_LPC_ORDER,)).astype(np.int32)
    lim = np.int64(1) << (bps_eff.astype(np.int64) - 1)
    warm_dtype = np.int64 if wide else np.int32
    warmup = (rng.integers(-(1 << 62), 1 << 62,
                           shape + (fmt.MAX_LPC_ORDER,))
              % (2 * lim[..., None]) - lim[..., None]).astype(warm_dtype)
    signal = (rng.integers(-(1 << 62), 1 << 62, shape + (N,))
              % (2 * lim[..., None]) - lim[..., None]).astype(warm_dtype)
    # partition orders: every order up to max_po somewhere
    po = rng.integers(0, max_po + 1, shape).astype(np.int32)
    po.flat[:max_po + 1] = np.arange(max_po + 1)[:po.size]
    use_rice2 = rng.random(shape) < rice2
    kmax = np.where(use_rice2, 20, 14)
    params = rng.integers(0, 64, shape + (P,)).astype(np.int32)  # unused tail
    residual = np.zeros(shape + (N,), np.int32)
    for b in range(B):
        for c in range(C):
            parts = 1 << int(po[b, c])
            for p in range(min(parts, P)):
                k = int(rng.integers(0, kmax[b, c] + 1))
                if rng.random() < escape:
                    k = ESCAPE_K_BASE + int(rng.choice([0, 31, 7, 16]))
                params[b, c, p] = k
            # an order whose partitions do not divide N: partition 0's
            # parameter for every sample
            kn = (np.full(N, params[b, c, 0]) if N % parts
                  else np.repeat(params[b, c, :parts], N // parts))
            esc = kn >= ESCAPE_K_BASE
            rawb = np.where(esc, kn - ESCAPE_K_BASE, 0)
            top = np.where(esc, np.maximum(rawb - 1, 0),
                           np.minimum(kn, 29) + 1).astype(np.int64)
            r = rng.integers(-(1 << 40), 1 << 40, N) % (
                np.int64(1) << top) - np.where(top > 0, np.int64(1) << (
                    np.maximum(top, 1) - 1), 0)
            r = np.where(esc & (rawb == 0), 0, r)
            long = ~esc & (rng.random(N) < big_q)
            r = np.where(long, rng.integers(20, 60, N) << np.minimum(
                kn, 20).astype(np.int64), r)
            residual[b, c] = np.clip(r, -(1 << 31), (1 << 31) - 1)
    residual[np.arange(N)[None, None, :] < order[..., None]] = 0
    # a RICE2 flag wherever a parameter in use passes RICE's 4-bit range
    for b in range(B):
        for c in range(C):
            k = params[b, c, :1 << int(po[b, c])]
            if ((k > 14) & (k < ESCAPE_K_BASE)).any():
                use_rice2[b, c] = True
    cfg = EncoderConfig.from_preset(
        5, blocksize=N, channels=C, bits_per_sample=bps,
        sample_rate=sample_rate).resolve()
    choice = dict(bits=np.zeros(shape, np.int32), type_=type_, order=order,
                  wasted=wasted, bps_eff=bps_eff, qcoeffs=qcoeffs,
                  shift=shift, precision=precision, warmup=warmup,
                  residual=residual, po=po, params=params,
                  use_rice2=use_rice2)
    return {"choice": choice, "signal": signal, "assignment": assignment,
            "frame_numbers": first_frame + np.arange(B, dtype=np.int64),
            "cfg": cfg, "blocksize": N, "layout": layout}


def cases():
    """[(label, batch)] for the corners above."""
    return [
        ("quad, every type, escapes, RICE2, orders 0..5",
         batch(1, B=6, C=2, N=4096, P=32, bps=16)),
        ("quad misfits", batch(2, B=4, C=2, N=4096, P=32, bps=16,
                               big_q=0.2, types=TYPES[2:])),
        ("safe, the 4048-sample tail", batch(3, B=2, C=2, N=4048, P=16,
                                             bps=16)),
        ("safe, N=4048 with P=2048: orders 5..11 skipped",
         batch(4, B=6, C=2, N=4048, P=2048, bps=16, types=TYPES[2:])),
        ("quad, blocksize 3072, 37800 Hz, 7-byte frame numbers",
         batch(5, B=4, C=2, N=3072, P=16, bps=16, sample_rate=37800,
               first_frame=(1 << 31) - 2)),
        ("safe, 8-bit blocksize tail (200), 16-bit Hz rate tail (37801)",
         batch(6, B=3, C=2, N=200, P=8, bps=16, sample_rate=37801,
               first_frame=70000)),
        ("quad, 8-bit blocksize tail, 8-bit kHz rate",
         batch(7, B=3, C=2, N=192 + 8, P=2, bps=12, sample_rate=12000,
               first_frame=0x7FF)),
        ("quad, mono 24-bit", batch(8, B=4, C=1, N=1152, P=8, bps=24,
                                    first_frame=(1 << 20) - 1)),
        ("safe, 8 channels", batch(9, B=2, C=8, N=1152, P=8, bps=16,
                                   layout="safe")),
        ("wide pairs, 33-bit side", batch(10, B=4, C=2, N=4096, P=16,
                                          bps=32, wide=True)),
        ("wide pairs under an explicit quad layout",
         batch(11, B=3, C=2, N=1024, P=8, bps=32, wide=True,
               layout="quad")),
        ("quad, a batch of one frame", batch(12, B=1, C=2, N=4096, P=32,
                                             bps=16)),
        ("quad, 133 frames of 1152: more clusters than SMs",
         batch(13, B=133, C=2, N=1152, P=8, bps=16)),
        ("safe, N=16: cluster ranks with no body slot",
         batch(14, B=3, C=1, N=16, P=16, bps=16)),
        ("quad, N=36 with P=8: partitions of 9 and 18, quads across them",
         batch(15, B=3, C=2, N=36, P=8, bps=16)),
        ("quad, minimal frames: CONSTANT mono 8-bit, 10 bytes",
         batch(16, B=3, C=1, N=192, P=1, bps=8, types=TYPES[:1],
               wasted_max=0)),
        ("quad, 256 frames of 16 samples: K5 a CTA a frame",
         batch(17, B=256, C=1, N=16, P=4, bps=16)),
    ]


def seal_batch(seed: int, *, W: int, byte_len, hdr_bytes,
               crc8_slot: bool = False) -> dict:
    """Packed words [B, W] (uint32 in int64) of random bytes, zero from
    each frame's byte_len - 2 on and at its CRC-8 byte (`crc8_slot`: that
    byte random too), with byte_len and hdr_bytes [B] int32.  `plain`:
    whether the case lies in the plain seal's domain (W a power of two,
    the CRC-8 byte inside the CRC-16's bytes, byte_len - 2 in [0, 4W])."""
    rng = np.random.default_rng(seed)
    byte_len = np.asarray(byte_len, np.int32)
    hdr_bytes = np.asarray(hdr_bytes, np.int32)
    B = len(byte_len)
    raw = rng.integers(0, 256, (B, 4 * W), dtype=np.uint8)
    at = np.arange(4 * W)[None, :]
    raw[at >= np.maximum(byte_len - 2, 0)[:, None]] = 0
    if not crc8_slot:
        raw[at == hdr_bytes[:, None]] = 0
    words = raw.reshape(B, W, 4).astype(np.int64)
    words = (words[..., 0] << 24) | (words[..., 1] << 16) \
        | (words[..., 2] << 8) | words[..., 3]
    L = byte_len.astype(np.int64) - 2
    plain = bool(W & (W - 1) == 0 and (L >= 0).all() and (L <= 4 * W).all()
                 and (hdr_bytes < L).all() and (hdr_bytes <= 15).all())
    return {"words": words, "byte_len": byte_len, "hdr_bytes": hdr_bytes,
            "plain": plain}


def seal_cases():
    """[(label, seal_batch)] for K5's corners."""
    rng = np.random.default_rng(99)
    res16 = np.concatenate([base + np.arange(16) for base in (33, 120, 200)])
    return [
        ("byte_len - 2 at every residue mod 16",
         seal_batch(1, W=64, byte_len=res16 + 2,
                    hdr_bytes=rng.integers(5, 16, len(res16)))),
        ("the longest header: 15 bytes before the CRC-8",
         seal_batch(2, W=64, byte_len=[18, 19, 24, 25, 120, 255],
                    hdr_bytes=[15] * 6)),
        ("minimal frames: the CRC-16 over the header and the CRC-8",
         seal_batch(3, W=8, byte_len=np.arange(5, 16) + 3,
                    hdr_bytes=np.arange(5, 16))),
        ("a CRC-8 byte in a word that is not zero: the deposit carries",
         seal_batch(4, W=64, byte_len=rng.integers(20, 250, 40),
                    hdr_bytes=rng.integers(5, 16, 40), crc8_slot=True)),
        ("a batch of one 10 KB frame: a cluster of 8",
         seal_batch(5, W=4096, byte_len=[10301], hdr_bytes=[6])),
        ("64 frames of ~10 KB: the main path's launch",
         seal_batch(6, W=4096, byte_len=rng.integers(9000, 11000, 64),
                    hdr_bytes=rng.integers(5, 16, 64))),
        ("256 frames of 1-4 KB: a CTA a frame",
         seal_batch(7, W=1024, byte_len=rng.integers(1000, 4097, 256),
                    hdr_bytes=rng.integers(5, 16, 256))),
        ("byte_len - 2 past 4W: the bytes past the row count as zeros",
         seal_batch(8, W=16, byte_len=[64, 65, 66, 67, 70, 100, 1000, 4099],
                    hdr_bytes=[6, 7, 8, 9, 10, 11, 12, 15])),
        ("byte_len 0, 1 and 2: L < 0 counts as 0",
         seal_batch(9, W=8, byte_len=[0, 1, 2, 3, 8], hdr_bytes=[5] * 5)),
        ("an odd W (37): rows not 16-byte aligned",
         seal_batch(10, W=37, byte_len=rng.integers(10, 149, 12),
                    hdr_bytes=rng.integers(5, 9, 12))),
    ]


def seal_host(words, byte_len, hdr_bytes) -> np.ndarray:
    """K5's contract on the host, byte by byte (ops/crc.py): the CRC-8 of
    each frame's first hdr_bytes bytes added into its byte hdr_bytes, then
    the CRC-16 of its first max(byte_len - 2, 0) bytes (those past the row
    zeros) added into the two bytes after them; a deposit adds into its
    uint32 word and is dropped outside [0, W)."""
    out = np.array(words, np.int64)
    W = out.shape[1]

    def as_bytes(row):
        return np.stack([(row >> s) & 0xFF for s in (24, 16, 8, 0)],
                        -1).reshape(-1).astype(np.uint8)

    def deposit(row, idx, value):
        if 0 <= idx and idx >> 2 < W:
            sh = (3 - (idx & 3)) * 8
            row[idx >> 2] = (int(row[idx >> 2]) + (int(value) << sh)) \
                & 0xFFFFFFFF

    for b in range(out.shape[0]):
        row, hb, bl = out[b], int(hdr_bytes[b]), int(byte_len[b])
        deposit(row, hb, crc.crc8(as_bytes(row)[:max(hb, 0)]))
        L = max(bl - 2, 0)
        msg = np.zeros(L, np.uint8)
        raw = as_bytes(row)[:L]
        msg[:len(raw)] = raw
        c16 = crc.crc16(msg)
        deposit(row, bl - 2, c16 >> 8)
        deposit(row, bl - 1, c16 & 0xFF)
    return out


def as_seal_inputs(case: dict, device):
    """(words, byte_len, hdr_bytes) on `device`."""
    return tuple(torch.from_numpy(case[k]).to(device)
                 for k in ("words", "byte_len", "hdr_bytes"))


def as_inputs(case: dict, device):
    """A case as assemble_fields' arguments on `device`: (choice, signal,
    assignment, frame_numbers, cfg, blocksize, layout)."""
    choice = SubframeChoice(**{k: torch.from_numpy(np.asarray(v)).to(device)
                               for k, v in case["choice"].items()})
    return (choice, torch.from_numpy(case["signal"]).to(device),
            torch.from_numpy(case["assignment"]).to(device),
            torch.from_numpy(case["frame_numbers"]).to(device),
            case["cfg"], case["blocksize"], case["layout"])
