"""Host reference FLAC decoder (pure Python/numpy) — correctness oracle.

A clean-room implementation of FLAC decoding from the format rules
catalogued in SURVEY.md §8 (reference behavior: src/libFLAC/stream_decoder.c).
Used by tests to verify encoder output independently of libFLAC, and as the
semantic model for the batched TPU decoder (flac_tpu/decoder.py).  Not a
performance path.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np

from . import format as fmt
from .ops.crc import crc8 as _crc8, crc16 as _crc16
from .utils.bits import BitReader, utf8_decode_int

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                      6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                      11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


@dataclass
class DecodedStream:
    sample_rate: int = 0
    channels: int = 0
    bits_per_sample: int = 0
    total_samples: int = 0
    md5: bytes = b""
    min_blocksize: int = 0
    max_blocksize: int = 0
    metadata: list = field(default_factory=list)
    frames: list = field(default_factory=list)   # per-frame info dicts
    samples: np.ndarray | None = None            # [C, n] int32


class FlacDecodeError(ValueError):
    pass


def _read_subframe(br: BitReader, blocksize: int, bps: int):
    """Returns (samples int64 array, info dict)."""
    pad = br.read(1)
    if pad != 0:
        raise FlacDecodeError("subframe padding bit set")
    type6 = br.read(6)
    wflag = br.read(1)
    wasted = 0
    if wflag:
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    info = {"wasted": wasted}

    if type6 == 0:
        val = br.read_signed(ebps)
        out = np.full(blocksize, val, np.int64)
        info["type"] = "CONSTANT"
        info["value"] = val
    elif type6 == 1:
        out = np.array([br.read_signed(ebps) for _ in range(blocksize)],
                       np.int64)
        info["type"] = "VERBATIM"
    elif (type6 & 0x38) == 0x08 and (type6 & 0x07) <= 4:
        order = type6 & 0x07
        info.update(type="FIXED", order=order)
        warm = [br.read_signed(ebps) for _ in range(order)]
        info["warmup"] = list(warm)
        res = _read_residual(br, blocksize, order, info)
        out = _restore_fixed(np.array(warm, np.int64), res, order, blocksize)
    elif type6 & 0x20:
        order = (type6 & 0x1F) + 1
        info.update(type="LPC", order=order)
        warm = [br.read_signed(ebps) for _ in range(order)]
        info["warmup"] = list(warm)
        prec = br.read(4) + 1
        if prec == 16:
            raise FlacDecodeError("invalid qlp precision 15")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacDecodeError("negative qlp shift")
        qlp = np.array([br.read_signed(prec) for _ in range(order)], np.int64)
        info.update(precision=prec, shift=shift, qlp=qlp.tolist())
        res = _read_residual(br, blocksize, order, info)
        out = _restore_lpc(np.array(warm, np.int64), res, qlp, shift,
                           blocksize)
    else:
        raise FlacDecodeError(f"reserved subframe type {type6:#04x}")

    if wasted:
        out = out << wasted
    return out, info


def _read_residual(br: BitReader, blocksize: int, order: int, info: dict):
    method = br.read(2)
    if method > 1:
        raise FlacDecodeError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape_code = (1 << plen) - 1
    po = br.read(4)
    parts = 1 << po
    if blocksize % parts:
        raise FlacDecodeError("partition count does not divide blocksize")
    psize = blocksize >> po
    if po and psize <= order:
        # partition 0 must still have samples left
        if psize < order:
            raise FlacDecodeError("partition smaller than predictor order")
    res = np.zeros(blocksize, np.int64)
    info.update(method=method, partition_order=po, params=[])
    pos = order
    for p in range(parts):
        n = psize - (order if p == 0 else 0)
        if n < 0:
            raise FlacDecodeError("negative partition length")
        k = br.read(plen)
        if k == escape_code:
            raw = br.read(5)
            info["params"].append(("raw", raw))
            for i in range(n):
                res[pos + i] = br.read_signed(raw) if raw else 0
        else:
            info["params"].append(k)
            for i in range(n):
                q = br.read_unary()
                u = (q << k) | (br.read(k) if k else 0)
                res[pos + i] = (u >> 1) ^ -(u & 1)
        pos += n
    info["residual"] = res[order:]
    return res


def _restore_fixed(warm, res, order, blocksize):
    out = np.zeros(blocksize, np.int64)
    out[:order] = warm
    coefs = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}
    c = coefs[order]
    for n in range(order, blocksize):
        pred = sum(ci * out[n - 1 - i] for i, ci in enumerate(c))
        out[n] = res[n] + pred
    return out


def _restore_lpc(warm, res, qlp, shift, blocksize):
    order = len(qlp)
    out = np.zeros(blocksize, np.int64)
    out[:order] = warm
    idx = np.arange(order)
    for n in range(order, blocksize):
        pred = int(np.dot(qlp, out[n - 1 - idx])) >> shift
        out[n] = res[n] + pred
    return out


def parse_metadata(data: bytes, pos: int):
    """Parse metadata blocks after fLaC; returns (stream, pos_after).
    Truncated/corrupt metadata raises FlacDecodeError, never leaks an
    IndexError (fuzz-hardened, cf. the reference's read_metadata_ error
    paths, stream_decoder.c:1668)."""
    try:
        return _parse_metadata(data, pos)
    except (IndexError, struct.error, OverflowError) as e:
        raise FlacDecodeError(f"truncated/corrupt metadata: {e}") from e


def _parse_metadata(data: bytes, pos: int):
    st = DecodedStream()
    last = False
    while not last:
        if pos + 4 > len(data):
            raise FlacDecodeError("truncated metadata header")
        hdr = int.from_bytes(data[pos:pos + 4], "big")
        last = bool(hdr >> 31)
        btype = (hdr >> 24) & 0x7F
        length = hdr & 0xFFFFFF
        body = data[pos + 4:pos + 4 + length]
        if len(body) != length:
            raise FlacDecodeError("truncated metadata block body")
        pos += 4 + length
        st.metadata.append((btype, body))
        if btype == fmt.METADATA_TYPE_STREAMINFO:
            if length < 34:
                raise FlacDecodeError("STREAMINFO too short")
            br = BitReader(body)
            st.min_blocksize = br.read(16)
            st.max_blocksize = br.read(16)
            br.read(24)  # min framesize
            br.read(24)  # max framesize
            st.sample_rate = br.read(20)
            st.channels = br.read(3) + 1
            st.bits_per_sample = br.read(5) + 1
            st.total_samples = br.read(36)
            st.md5 = body[18:34]
    return st, pos


def decode_frame(data: bytes, pos: int, st: DecodedStream):
    """Decode one frame at byte offset pos; returns (samples [C,N], info,
    new_pos)."""
    start = pos
    if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
        raise FlacDecodeError(f"no frame sync at {pos}")
    br = BitReader(data, pos * 8)
    sync = br.read(14)
    br.read(1)  # reserved
    variable = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    bps_code = br.read(3)
    if br.read(1):
        raise FlacDecodeError("frame header reserved bit set")
    number, nbytes = utf8_decode_int(data, br.pos // 8)
    br.pos += nbytes * 8

    if bs_code == 0:
        raise FlacDecodeError("reserved blocksize code")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZE_TABLE[bs_code]

    if sr_code == 0:
        sample_rate = st.sample_rate
    elif sr_code == 12:
        sample_rate = br.read(8) * 1000
    elif sr_code == 13:
        sample_rate = br.read(16)
    elif sr_code == 14:
        sample_rate = br.read(16) * 10
    elif sr_code == 15:
        raise FlacDecodeError("invalid sample rate code")
    else:
        sample_rate = _SAMPLE_RATE_TABLE[sr_code]

    bps = st.bits_per_sample if bps_code == 0 else _BPS_TABLE[bps_code]

    hdr_len = br.pos // 8 - start
    crc_got = br.read(8)
    crc_want = _crc8(data[start:start + hdr_len])
    if crc_got != crc_want:
        raise FlacDecodeError(
            f"frame header CRC8 mismatch: {crc_got:#x} != {crc_want:#x}")

    if ch_code < 8:
        channels = ch_code + 1
        assignment = fmt.CHANNEL_ASSIGNMENT_INDEPENDENT
    elif ch_code == 8:
        channels, assignment = 2, fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE
    elif ch_code == 9:
        channels, assignment = 2, fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE
    elif ch_code == 10:
        channels, assignment = 2, fmt.CHANNEL_ASSIGNMENT_MID_SIDE
    else:
        raise FlacDecodeError("reserved channel assignment")

    subframes = []
    infos = []
    for c in range(channels):
        cbps = bps
        if assignment == fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE and c == 1:
            cbps += 1
        elif assignment == fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE and c == 0:
            cbps += 1
        elif assignment == fmt.CHANNEL_ASSIGNMENT_MID_SIDE and c == 1:
            cbps += 1
        sf, inf = _read_subframe(br, blocksize, cbps)
        subframes.append(sf)
        infos.append(inf)
    br.align_to_byte()
    crc16_got = br.read(16)
    frame_len = br.pos // 8 - start
    crc16_want = _crc16(data[start:start + frame_len - 2])
    if crc16_got != crc16_want:
        raise FlacDecodeError(
            f"frame CRC16 mismatch: {crc16_got:#x} != {crc16_want:#x}")

    # undo stereo decorrelation (stream_decoder.c:3476-3526)
    if assignment == fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE:
        left, side = subframes
        subframes = [left, left - side]
    elif assignment == fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE:
        side, right = subframes
        subframes = [right + side, right]
    elif assignment == fmt.CHANNEL_ASSIGNMENT_MID_SIDE:
        mid, side = subframes
        mid2 = (mid << 1) | (side & 1)
        subframes = [(mid2 + side) >> 1, (mid2 - side) >> 1]

    out = np.stack(subframes).astype(np.int64)
    info = {"number": number, "blocksize": blocksize, "variable": variable,
            "assignment": assignment, "subframes": infos,
            "offset": start, "size": frame_len,
            "sample_rate": sample_rate, "bps": bps}
    return out, info, start + frame_len


def decode_stream(data: bytes, *, verify_md5: bool = True) -> DecodedStream:
    if data[:4] != fmt.STREAM_SYNC_STRING:
        raise FlacDecodeError("missing fLaC marker")
    st, pos = parse_metadata(data, 4)
    chunks = []
    while pos < len(data):
        samples, info, pos = decode_frame(data, pos, st)
        st.frames.append(info)
        chunks.append(samples)
    st.samples = np.concatenate(chunks, axis=1).astype(np.int32) \
        if chunks else np.zeros((st.channels, 0), np.int32)
    if verify_md5 and st.md5 != b"\x00" * 16:
        from .encoder import interleave_for_md5
        got = hashlib.md5(interleave_for_md5(
            st.samples, st.bits_per_sample)).digest()
        if got != st.md5:
            raise FlacDecodeError("stream MD5 mismatch")
    return st
