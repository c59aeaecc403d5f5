"""Foreign metadata storage (--keep-foreign-metadata).

Copy of flac_tpu/foreign.py (host only).
Host-side counterpart of src/flac/foreign_metadata.c (958 LoC) and
doc/foreign_metadata_storage.md: when converting WAV/RF64/AIFF(-C)/W64 to
FLAC, every container chunk is copied into its own APPLICATION metadata
block (ID "riff"/"aiff"/"w64 ") in order — completely, except the
outermost chunk and the audio chunk, of which only the headers are kept.
Restoring on decode splices the decoded audio payload back between the
stored chunks, reproducing the original container byte-for-byte.

Block layouts follow the reference scanner exactly so files produced by
either implementation restore through the other:
- RIFF/RF64: first block = 12 bytes (main header + "WAVE"); "data" chunk
  stored as its 8-byte header; other chunks complete including the pad
  byte (foreign_metadata.c:210-358).
- AIFF/AIFF-C: first block = 12 bytes (FORM header + form type); "SSND"
  stored as 8-byte header + offset/blockSize fields + `offset` bytes of
  unaligned pre-audio data (foreign_metadata.c:119-209).
- Wave64: first block = 40 bytes; "data" chunk stored as its 24-byte
  GUID+size header; sizes include the header and pad to 8
  (foreign_metadata.c:360-470).
"""

from __future__ import annotations

import struct

APPID_RIFF = b"riff"
APPID_AIFF = b"aiff"
APPID_W64 = b"w64 "

_W64_DATA_GUID = bytes.fromhex("64617461F3ACD3118CD100C04F8EDB8A")
_W64_FMT_GUID = bytes.fromhex("666D7420F3ACD3118CD100C04F8EDB8A")


class ForeignError(ValueError):
    pass


def scan_foreign(data: bytes):
    """Container bytes -> (application_id, [block payloads]) or None if
    the container kind has no foreign-metadata mapping."""
    if data[:4] in (b"RIFF", b"RF64"):
        return APPID_RIFF, _scan_riff(data)
    if data[:4] == b"FORM":
        return APPID_AIFF, _scan_aiff(data)
    if data[:8] == b"riff\x2E\x91\xCF\x11":
        return APPID_W64, _scan_w64(data)
    return None


def _scan_riff(data: bytes) -> list[bytes]:
    if data[8:12] != b"WAVE":
        raise ForeignError("unsupported RIFF layout")
    blocks = [data[:12]]
    is_rf64 = data[:4] == b"RF64"
    ds64_data_size = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if cid == b"ds64":
            ds64_data_size = struct.unpack(
                "<Q", data[pos + 16:pos + 24])[0]
        if is_rf64 and cid == b"data" and size == 0xFFFFFFFF:
            if ds64_data_size is None:
                raise ForeignError("RF64 data chunk before ds64")
            size = ds64_data_size
        size += size & 1
        if cid == b"data":
            blocks.append(data[pos:pos + 8])
        else:
            blocks.append(data[pos:pos + 8 + size])
        pos += 8 + size
    return blocks


def _scan_aiff(data: bytes) -> list[bytes]:
    if data[8:12] not in (b"AIFF", b"AIFC"):
        raise ForeignError("unsupported FORM layout")
    blocks = [data[:12]]
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        size += size & 1
        if cid == b"SSND":
            ssnd_offset = struct.unpack(">I", data[pos + 8:pos + 12])[0]
            blocks.append(data[pos:pos + 16 + ssnd_offset])
        else:
            blocks.append(data[pos:pos + 8 + size])
        pos += 8 + size
    return blocks


def _scan_w64(data: bytes) -> list[bytes]:
    blocks = [data[:40]]
    pos = 40
    while pos + 24 <= len(data):
        guid = data[pos:pos + 16]
        size = struct.unpack("<Q", data[pos + 16:pos + 24])[0]
        size = (size + 7) & ~7
        if size < 24:
            raise ForeignError("invalid Wave64 chunk length")
        if guid == _W64_DATA_GUID:
            blocks.append(data[pos:pos + 24])
        else:
            blocks.append(data[pos:pos + size])
        pos += size
    return blocks


def foreign_kind(appid: bytes, blocks: list[bytes]) -> str:
    """Output container implied by stored foreign metadata."""
    if appid == APPID_RIFF:
        return "rf64" if blocks and blocks[0][:4] == b"RF64" else "wav"
    if appid == APPID_AIFF:
        if blocks and blocks[0][8:12] == b"AIFC":
            for blk in blocks[1:]:
                if blk[:4] == b"COMM" and len(blk) >= 30 and \
                        blk[26:30] == b"sowt":
                    return "aiff-c-sowt"
            return "aiff-c-none"
        return "aiff"
    if appid == APPID_W64:
        return "w64"
    raise ForeignError(f"unknown foreign metadata ID {appid!r}")


def restore_foreign(appid: bytes, blocks: list[bytes],
                    audio_payload: bytes) -> bytes:
    """Rebuild the original container around the decoded audio payload."""
    if not blocks:
        raise ForeignError("no foreign metadata blocks")
    out = bytearray()
    found_audio = False
    for i, blk in enumerate(blocks):
        out += blk
        if appid == APPID_RIFF and i > 0 and blk[:4] == b"data" \
                and len(blk) == 8:
            found_audio = True
            size = struct.unpack("<I", blk[4:8])[0]
            out += audio_payload
            if size == 0xFFFFFFFF or size & 1:
                pass
            if len(audio_payload) & 1:
                out += b"\x00"
        elif appid == APPID_AIFF and i > 0 and blk[:4] == b"SSND":
            found_audio = True
            out += audio_payload
            ssnd_size = struct.unpack(">I", blk[4:8])[0]
            # chunk data = 8 offset/blockSize bytes + offset + audio (the
            # reference drops any unaligned tail, foreign_metadata.c:184)
            if ssnd_size & 1:
                out += b"\x00"
        elif appid == APPID_W64 and i > 0 and blk[:16] == _W64_DATA_GUID:
            found_audio = True
            out += audio_payload
            pad = (-(24 + len(audio_payload))) % 8
            out += b"\x00" * pad
    if not found_audio:
        raise ForeignError("foreign metadata has no audio chunk header")
    return bytes(out)


def extract_from_flac_metadata(meta: list) -> tuple[bytes, list[bytes]] | None:
    """(type, body) metadata pairs -> (appid, ordered foreign blocks)."""
    from . import format as fmt
    for appid in (APPID_RIFF, APPID_AIFF, APPID_W64):
        blocks = [body[4:] for t, body in meta
                  if t == fmt.METADATA_TYPE_APPLICATION
                  and body[:4] == appid]
        if blocks:
            return appid, blocks
    return None
