"""Audio container I/O: WAV/RF64/W64/AIFF/raw read and write.

Copy of flac_tpu/container.py.  Host-side counterpart of src/flac/encode.c
(format sniffing + header parsing, encode.c:178-860) and decode.c
(writers, decode.c:121-1500).  Returns/consumes [C, n] int32 sample arrays
ready for the encoder.  A FLAC or Ogg FLAC input is decoded on `device`
(None means "cuda"; pass "cpu" to decode on the CPU).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class AudioInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    samples: np.ndarray  # [C, n] int32
    # (type, body) metadata blocks carried from a FLAC input for
    # FLAC-to-FLAC re-encode preservation (encode.c:805,2443-2522)
    metadata: list | None = None


class ContainerError(ValueError):
    pass


def _pcm_from_bytes(raw: bytes, channels: int, bps: int,
                    big_endian: bool = False,
                    unsigned8: bool = True) -> np.ndarray:
    """Interleaved PCM bytes -> [C, n] int32."""
    nb = (bps + 7) // 8
    total = len(raw) // (nb * channels) * nb * channels
    a = np.frombuffer(raw[:total], np.uint8).reshape(-1, channels, nb)
    if big_endian:
        a = a[..., ::-1]
    # little-endian assemble into int32 with sign extension
    out = np.zeros(a.shape[:2], np.uint32)
    for i in range(nb):
        out |= a[..., i].astype(np.uint32) << (8 * i)
    if nb == 1 and unsigned8:
        out = (out ^ 0x80)  # WAV 8-bit is unsigned
    shift = 32 - 8 * nb
    signed = (out.astype(np.uint32) << shift).astype(np.int32) >> shift
    # container samples are stored in nb bytes; bps may be < 8*nb with the
    # data left-justified (e.g. 12-bit in 16-bit containers): right-align
    pad = 8 * nb - bps
    if pad:
        signed = signed >> pad
    return np.ascontiguousarray(signed.T)


def _pcm_to_bytes(pcm: np.ndarray, bps: int, big_endian: bool = False,
                  unsigned8: bool = True) -> bytes:
    nb = (bps + 7) // 8
    pad = 8 * nb - bps
    a = np.ascontiguousarray(pcm.T.astype(np.int32) << pad)
    if nb == 1 and unsigned8:
        a = (a ^ np.int32(-128)) & 0xFF
    le = a.astype("<i4").view(np.uint8).reshape(*a.shape, 4)[..., :nb]
    if big_endian:
        le = le[..., ::-1]
    return np.ascontiguousarray(le).tobytes()


# ---------------------------------------------------------------------------
# WAV / RF64
# ---------------------------------------------------------------------------

def read_wav(data: bytes, ignore_chunk_sizes: bool = False) -> AudioInfo:
    if data[:4] not in (b"RIFF", b"RF64"):
        raise ContainerError("not a RIFF/RF64 file")
    is_rf64 = data[:4] == b"RF64"
    if data[8:12] != b"WAVE":
        raise ContainerError("not a WAVE file")
    pos = 12
    fmt_info = None
    data_chunk = None
    ds64_data_size = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        csize = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + csize]
        if cid == b"ds64":
            if len(body) < 16:
                raise ContainerError("truncated ds64 chunk")
            ds64_data_size = struct.unpack("<Q", body[8:16])[0]
        elif cid == b"fmt ":
            if len(body) < 16:
                raise ContainerError("truncated fmt chunk")
            fmt_info = struct.unpack("<HHIIHH", body[:16])
            if fmt_info[0] == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
                if len(body) < 26:
                    raise ContainerError("truncated extensible fmt chunk")
                valid_bits = struct.unpack("<H", body[18:20])[0]
                sub = struct.unpack("<H", body[24:26])[0]
                fmt_info = (sub, *fmt_info[1:5], valid_bits or fmt_info[5])
        elif cid == b"data":
            if ignore_chunk_sizes:
                # --ignore-chunk-sizes (encode.c): trust EOF, not the
                # header — for streams piped with a bogus/0 data size
                data_chunk = data[pos + 8:]
                break
            if is_rf64 and csize == 0xFFFFFFFF:
                csize = ds64_data_size
                body = data[pos + 8:pos + 8 + csize]
            data_chunk = body
        pos += 8 + csize + (csize & 1)
    if fmt_info is None or data_chunk is None:
        raise ContainerError("missing fmt/data chunk")
    wfmt, channels, rate, _, _block_align, bps = fmt_info
    if wfmt != 1:
        raise ContainerError(f"unsupported WAV format tag {wfmt}")
    samples = _pcm_from_bytes(data_chunk, channels, bps)
    return AudioInfo(rate, channels, bps, samples)


def _fmt_chunk_body(channels: int, sample_rate: int, bps: int) -> bytes:
    """fmt chunk with the reference's WAVEFORMATEXTENSIBLE rule: plain PCM
    for mono/stereo at 8/16 bits, EXTENSIBLE otherwise
    (src/flac/decode.c:121-132 + write logic around decode.c:800-900)."""
    nb = (bps + 7) // 8
    block_align = channels * nb
    base = struct.pack("<HHIIHH", 0xFFFE if _wav_needs_ext(channels, bps)
                       else 1, channels, sample_rate,
                       sample_rate * block_align, block_align, nb * 8)
    if not _wav_needs_ext(channels, bps):
        return base
    # cbSize(22) + validBits + channelMask + SubFormat GUID (PCM)
    guid = bytes.fromhex("0100000000001000800000aa00389b71")
    return base + struct.pack("<HHI", 22, bps, 0) + guid


def _wav_needs_ext(channels: int, bps: int) -> bool:
    return channels > 2 or bps not in (8, 16)


def write_wav(info_or_pcm, sample_rate=None, bits_per_sample=None) -> bytes:
    if isinstance(info_or_pcm, AudioInfo):
        pcm = info_or_pcm.samples
        sample_rate = info_or_pcm.sample_rate
        bits_per_sample = info_or_pcm.bits_per_sample
    else:
        pcm = info_or_pcm
    channels, n = pcm.shape
    nb = (bits_per_sample + 7) // 8
    payload = _pcm_to_bytes(pcm, bits_per_sample)
    fmt_body = _fmt_chunk_body(channels, sample_rate, bits_per_sample)
    body = (b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", len(payload)) + payload
            + (b"\x00" if len(payload) & 1 else b""))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def write_rf64(info_or_pcm, sample_rate=None, bits_per_sample=None) -> bytes:
    """RF64 writer (64-bit sizes in a ds64 chunk; decode.c RF64 output)."""
    if isinstance(info_or_pcm, AudioInfo):
        pcm = info_or_pcm.samples
        sample_rate = info_or_pcm.sample_rate
        bits_per_sample = info_or_pcm.bits_per_sample
    else:
        pcm = info_or_pcm
    channels, n = pcm.shape
    payload = _pcm_to_bytes(pcm, bits_per_sample)
    fmt_body = _fmt_chunk_body(channels, sample_rate, bits_per_sample)
    def build(riff_size: int) -> bytes:
        ds64 = struct.pack("<QQQI", riff_size, len(payload), n, 0)
        return (b"WAVE"
                + b"ds64" + struct.pack("<I", len(ds64)) + ds64
                + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
                + b"data" + struct.pack("<I", 0xFFFFFFFF) + payload
                + (b"\x00" if len(payload) & 1 else b""))

    body = build(len(build(0)))
    return b"RF64" + struct.pack("<I", 0xFFFFFFFF) + body


def write_w64(info_or_pcm, sample_rate=None, bits_per_sample=None) -> bytes:
    """Wave64 writer (GUID chunks, 64-bit sizes include the 24-byte chunk
    header; decode.c Wave64 output)."""
    if isinstance(info_or_pcm, AudioInfo):
        pcm = info_or_pcm.samples
        sample_rate = info_or_pcm.sample_rate
        bits_per_sample = info_or_pcm.bits_per_sample
    else:
        pcm = info_or_pcm
    channels, n = pcm.shape
    payload = _pcm_to_bytes(pcm, bits_per_sample)
    fmt_body = _fmt_chunk_body(channels, sample_rate, bits_per_sample)

    def chunk(guid: bytes, body: bytes) -> bytes:
        size = 24 + len(body)
        pad = (-size) % 8
        return guid + struct.pack("<Q", size) + body + b"\x00" * pad

    inner = _W64_WAVE + chunk(_W64_FMT, fmt_body) + chunk(_W64_DATA, payload)
    total = 16 + 8 + len(inner)
    return _W64_RIFF + struct.pack("<Q", total) + inner


def write_raw(pcm: np.ndarray, bits_per_sample: int, *,
              big_endian: bool = False, signed: bool = True) -> bytes:
    return _pcm_to_bytes(pcm, bits_per_sample, big_endian=big_endian,
                         unsigned8=not signed)


# ---------------------------------------------------------------------------
# AIFF / AIFF-C
# ---------------------------------------------------------------------------

def _f80_to_int(b: bytes) -> int:
    """80-bit IEEE extended float -> int (AIFF sample rates)."""
    sign_exp = struct.unpack(">H", b[:2])[0]
    mant = struct.unpack(">Q", b[2:10])[0]
    exp = (sign_exp & 0x7FFF) - 16383
    val = mant / (1 << 63) * (2 ** exp)
    return int(round(val))


def _int_to_f80(v: int) -> bytes:
    if v == 0:
        return b"\x00" * 10
    exp = v.bit_length() - 1
    mant = v << (63 - exp)
    return struct.pack(">HQ", 16383 + exp, mant)


def read_aiff(data: bytes, ignore_chunk_sizes: bool = False) -> AudioInfo:
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ContainerError("not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = None
    ssnd = None
    little = False
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        csize = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + csize]
        if cid == b"COMM":
            channels, nframes, bps = struct.unpack(">HIH", body[:8])
            rate = _f80_to_int(body[8:18])
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
                if compression == b"sowt":
                    little = True
                elif compression not in (b"NONE",):
                    raise ContainerError(
                        f"unsupported AIFF-C compression {compression!r}")
            comm = (channels, nframes, bps, rate)
        elif cid == b"SSND":
            offset = struct.unpack(">I", body[:4])[0]
            if ignore_chunk_sizes:
                ssnd = data[pos + 16 + offset:]
                break
            ssnd = body[8 + offset:]
        pos += 8 + csize + (csize & 1)
    if comm is None or ssnd is None:
        raise ContainerError("missing COMM/SSND chunk")
    channels, nframes, bps, rate = comm
    samples = _pcm_from_bytes(ssnd, channels, bps, big_endian=not little,
                              unsigned8=False)
    return AudioInfo(rate, channels, bps, samples[:, :nframes])


def write_aiff(pcm: np.ndarray, sample_rate: int, bits_per_sample: int,
               compression: bytes | None = None) -> bytes:
    """AIFF writer; compression b"NONE"/b"sowt" selects AIFF-C output
    (--force-aiff-c-{none,sowt}-format; sowt stores little-endian PCM)."""
    channels, n = pcm.shape
    little = compression == b"sowt"
    payload = _pcm_to_bytes(pcm, bits_per_sample, big_endian=not little,
                            unsigned8=False)
    comm = struct.pack(">HIH", channels, n, bits_per_sample) \
        + _int_to_f80(sample_rate)
    chunks = b""
    if compression is not None:
        name = b"\x00" if compression == b"NONE" else b"\x00"
        comm += compression + name
        if len(comm) & 1:
            comm += b"\x00"
        chunks += b"FVER" + struct.pack(">II", 4, 0xA2805140)
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (b"AIFC" if compression is not None else b"AIFF") + chunks \
        + b"COMM" + struct.pack(">I", len(comm)) + comm \
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd \
        + (b"\x00" if len(ssnd) & 1 else b"")
    return b"FORM" + struct.pack(">I", len(body)) + body


# ---------------------------------------------------------------------------
# Wave64
# ---------------------------------------------------------------------------

# the Wave64 format's GUIDs (riff 66666972-912E-11CF-A5D6-28DB04C10000;
# wave, fmt and data xxxxxxxx-ACF3-11D3-8CD1-00C04F8EDB8A), as foreign.py
# has them.  flac_tpu/container.py ends the last three in 8CD10080
# 5F9CF04F, so it neither reads another tool's Wave64 nor writes one that
# --keep-foreign-metadata can restore; the port keeps the format's bytes.
_W64_RIFF = bytes.fromhex("72696666 2E91CF11 A5D628DB 04C10000".replace(" ", ""))
_W64_WAVE = bytes.fromhex("77617665 F3ACD311 8CD100C0 4F8EDB8A".replace(" ", ""))
_W64_FMT = bytes.fromhex("666D7420 F3ACD311 8CD100C0 4F8EDB8A".replace(" ", ""))
_W64_DATA = bytes.fromhex("64617461 F3ACD311 8CD100C0 4F8EDB8A".replace(" ", ""))


def read_w64(data: bytes) -> AudioInfo:
    if data[:16] != _W64_RIFF or data[24:40] != _W64_WAVE:
        raise ContainerError("not a Wave64 file")
    pos = 40
    fmt_info = None
    payload = None
    while pos + 24 <= len(data):
        guid = data[pos:pos + 16]
        csize = struct.unpack("<Q", data[pos + 16:pos + 24])[0]
        body = data[pos + 24:pos + csize]
        if guid == _W64_FMT:
            fmt_info = struct.unpack("<HHIIHH", body[:16])
        elif guid == _W64_DATA:
            payload = body
        pos += (csize + 7) & ~7
    if fmt_info is None or payload is None:
        raise ContainerError("missing fmt/data chunk")
    wfmt, channels, rate, _, _, bps = fmt_info
    samples = _pcm_from_bytes(payload, channels, bps)
    return AudioInfo(rate, channels, bps, samples)


def read_raw(data: bytes, *, sample_rate: int, channels: int,
             bits_per_sample: int, big_endian: bool = False,
             signed: bool = True) -> AudioInfo:
    samples = _pcm_from_bytes(data, channels, bits_per_sample,
                              big_endian=big_endian, unsigned8=not signed)
    return AudioInfo(sample_rate, channels, bits_per_sample, samples)


def read_flac_input(data: bytes, device=None) -> AudioInfo:
    """FLAC (or Ogg FLAC) input for re-encode (encode.c:805): decode to
    PCM on `device` and carry every non-STREAMINFO/PADDING metadata block
    so the new stream preserves tags/cuesheets/pictures like the reference
    does (encode.c:2443-2522)."""
    from . import format as fmt
    from .decoder import decode_stream_auto
    from .metadata import parse_metadata_blocks

    st = decode_stream_auto(data, device=device)
    meta = []
    if data[:4] == fmt.STREAM_SYNC_STRING:
        for btype, body in parse_metadata_blocks(data):
            if btype not in (fmt.METADATA_TYPE_STREAMINFO,
                             fmt.METADATA_TYPE_PADDING,
                             fmt.METADATA_TYPE_SEEKTABLE):
                meta.append((btype, body))
    return AudioInfo(st.sample_rate, st.channels, st.bits_per_sample,
                     np.asarray(st.samples), metadata=meta)


def sniff_and_read(data: bytes, ignore_chunk_sizes: bool = False, *,
                   device=None) -> AudioInfo:
    if data[:4] in (b"RIFF", b"RF64"):
        return read_wav(data, ignore_chunk_sizes)
    if data[:4] == b"FORM":
        return read_aiff(data, ignore_chunk_sizes)
    if data[:16] == _W64_RIFF:
        return read_w64(data)
    if data[:4] == b"fLaC" or data[:4] == b"OggS":
        return read_flac_input(data, device=device)
    raise ContainerError("unrecognized container (use read_raw for raw PCM)")
