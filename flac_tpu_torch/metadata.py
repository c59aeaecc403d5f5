"""FLAC metadata blocks: objects, (de)serialization, and file-level editing.

Host-side counterpart of the reference's three-level metadata interface
(src/libFLAC/metadata_object.c, metadata_iterators.c; include/FLAC/
metadata.h:165-1285):

  level 0 — one-shot getters (get_streaminfo / get_tags / get_picture...)
  level 1 — SimpleIterator: in-place single-block file editing with
            padding absorption; never loads the audio frames
            (metadata.h:374-663, metadata_iterators.c simple_iterator_*)
  level 2 — Chain: read all blocks, edit, write back with padding reuse

Port of flac_tpu/metadata.py, byte for byte the same on every path but
four, where the copy is fixed on purpose:
  - SimpleIterator.insert_block_after on the last block appends at the end
    of the chain (and clears the old last block's is_last flag);
  - a temp-file rewrite (SimpleIterator, Chain.write_file) keeps the
    file's mode bits;
  - delete_block(use_padding=True) with no PADDING after it zeroes the
    deleted body as well as retyping its header;
  - _rewrite_region takes no cursor offset (callers re-seek by index).
"""

from __future__ import annotations

import os
import stat
import struct
import tempfile
from dataclasses import dataclass, field

from . import format as fmt
from .ref_decoder import FlacDecodeError
from .utils.bits import BitReader, BitWriter


class MetadataError(FlacDecodeError):
    """Malformed metadata.  Subclasses FlacDecodeError: a broken metadata
    chain is a decode error to callers that treat the stream as a whole."""


@dataclass
class StreamInfoBlock:
    min_blocksize: int = 0
    max_blocksize: int = 0
    min_framesize: int = 0
    max_framesize: int = 0
    sample_rate: int = 0
    channels: int = 0
    bits_per_sample: int = 0
    total_samples: int = 0
    md5: bytes = b"\x00" * 16

    TYPE = fmt.METADATA_TYPE_STREAMINFO

    @classmethod
    def parse(cls, body: bytes) -> "StreamInfoBlock":
        br = BitReader(body)
        return cls(
            min_blocksize=br.read(16), max_blocksize=br.read(16),
            min_framesize=br.read(24), max_framesize=br.read(24),
            sample_rate=br.read(20), channels=br.read(3) + 1,
            bits_per_sample=br.read(5) + 1, total_samples=br.read(36),
            md5=body[18:34])

    def to_bytes(self) -> bytes:
        bw = BitWriter()
        bw.write(self.min_blocksize, 16)
        bw.write(self.max_blocksize, 16)
        bw.write(self.min_framesize, 24)
        bw.write(self.max_framesize, 24)
        bw.write(self.sample_rate, 20)
        bw.write(self.channels - 1, 3)
        bw.write(self.bits_per_sample - 1, 5)
        bw.write(self.total_samples, 36)
        bw.write_bytes(self.md5)
        return bw.getvalue()


@dataclass
class PaddingBlock:
    length: int = 0
    TYPE = fmt.METADATA_TYPE_PADDING

    @classmethod
    def parse(cls, body: bytes) -> "PaddingBlock":
        return cls(length=len(body))

    def to_bytes(self) -> bytes:
        return b"\x00" * self.length


@dataclass
class ApplicationBlock:
    app_id: bytes = b"\x00\x00\x00\x00"
    data: bytes = b""
    TYPE = fmt.METADATA_TYPE_APPLICATION

    @classmethod
    def parse(cls, body: bytes) -> "ApplicationBlock":
        return cls(app_id=body[:4], data=body[4:])

    def to_bytes(self) -> bytes:
        return self.app_id + self.data


@dataclass
class SeekPoint:
    sample_number: int
    stream_offset: int
    frame_samples: int

    @property
    def is_placeholder(self) -> bool:
        return self.sample_number == fmt.SEEKPOINT_PLACEHOLDER


@dataclass
class SeekTableBlock:
    points: list = field(default_factory=list)
    TYPE = fmt.METADATA_TYPE_SEEKTABLE

    @classmethod
    def parse(cls, body: bytes) -> "SeekTableBlock":
        pts = []
        for off in range(0, len(body) - 17, 18):
            sn, so, fs = struct.unpack(">QQH", body[off:off + 18])
            pts.append(SeekPoint(sn, so, fs))
        return cls(points=pts)

    def to_bytes(self) -> bytes:
        return b"".join(struct.pack(">QQH", p.sample_number,
                                    p.stream_offset, p.frame_samples)
                        for p in self.points)

    def is_legal(self) -> bool:
        """format.c:242-284: ascending unique sample numbers, placeholders
        only at the end."""
        prev = -1
        seen_placeholder = False
        for p in self.points:
            if p.is_placeholder:
                seen_placeholder = True
                continue
            if seen_placeholder or p.sample_number <= prev:
                return False
            prev = p.sample_number
        return True

    @classmethod
    def template_spaced(cls, total_samples: int, sample_rate: int,
                        seconds: float) -> "SeekTableBlock":
        """'-S Ns' template (grabbag/seektable.c spaced points): target
        sample numbers every N seconds, resolved to real frame offsets by
        the encoder at finish."""
        spacing = max(1, int(seconds * sample_rate))
        if not total_samples:
            return cls(points=[SeekPoint(fmt.SEEKPOINT_PLACEHOLDER, 0, 0)])
        targets = range(0, total_samples, spacing)
        return cls(points=[SeekPoint(t, 0, 0) for t in targets])

    @classmethod
    def template_count(cls, count: int,
                       total_samples: int = 0) -> "SeekTableBlock":
        """'-S #x' template: `count` evenly spaced target points."""
        if not total_samples:
            return cls(points=[SeekPoint(fmt.SEEKPOINT_PLACEHOLDER, 0, 0)
                               for _ in range(count)])
        return cls(points=[SeekPoint(total_samples * i // count, 0, 0)
                           for i in range(count)])


@dataclass
class VorbisCommentBlock:
    vendor: str = "flac_tpu"
    comments: list = field(default_factory=list)  # list[str] "KEY=value"
    TYPE = fmt.METADATA_TYPE_VORBIS_COMMENT

    @classmethod
    def parse(cls, body: bytes) -> "VorbisCommentBlock":
        pos = 0
        vlen = struct.unpack("<I", body[pos:pos + 4])[0]; pos += 4
        vendor = body[pos:pos + vlen].decode("utf-8", "replace")
        pos += vlen
        n = struct.unpack("<I", body[pos:pos + 4])[0]; pos += 4
        comments = []
        for _ in range(n):
            clen = struct.unpack("<I", body[pos:pos + 4])[0]; pos += 4
            comments.append(body[pos:pos + clen].decode("utf-8", "replace"))
            pos += clen
        return cls(vendor=vendor, comments=comments)

    def to_bytes(self) -> bytes:
        out = bytearray()
        v = self.vendor.encode("utf-8")
        out += struct.pack("<I", len(v)) + v
        out += struct.pack("<I", len(self.comments))
        for c in self.comments:
            cb = c.encode("utf-8")
            out += struct.pack("<I", len(cb)) + cb
        return bytes(out)

    # -- entry ops mirroring FLAC__metadata_object_vorbiscomment_* --

    def get(self, name: str) -> list:
        pre = name.upper() + "="
        return [c[len(pre):] for c in self.comments
                if c.upper().startswith(pre)]

    def set(self, name: str, value: str, replace_all: bool = True) -> None:
        if replace_all:
            self.remove(name)
        self.comments.append(f"{name}={value}")

    def remove(self, name: str) -> int:
        pre = name.upper() + "="
        before = len(self.comments)
        self.comments = [c for c in self.comments
                         if not c.upper().startswith(pre)]
        return before - len(self.comments)


@dataclass
class CueSheetTrackIndex:
    offset: int
    number: int


@dataclass
class CueSheetTrack:
    offset: int = 0
    number: int = 0
    isrc: bytes = b"\x00" * 12
    is_audio: bool = True
    pre_emphasis: bool = False
    indices: list = field(default_factory=list)


@dataclass
class CueSheetBlock:
    media_catalog_number: bytes = b"\x00" * 128
    lead_in: int = 0
    is_cd: bool = False
    tracks: list = field(default_factory=list)
    TYPE = fmt.METADATA_TYPE_CUESHEET

    @classmethod
    def parse(cls, body: bytes) -> "CueSheetBlock":
        br = BitReader(body)
        mcn = body[:128]
        br.pos = 128 * 8
        lead_in = br.read(64)
        is_cd = bool(br.read(1))
        br.read(7 + 258 * 8)  # reserved
        ntracks = br.read(8)
        tracks = []
        for _ in range(ntracks):
            offset = br.read(64)
            number = br.read(8)
            isrc = bytes(br.read(8) for _ in range(12))
            ttype = br.read(1)
            pre = br.read(1)
            br.read(6 + 13 * 8)
            nidx = br.read(8)
            idxs = []
            for _ in range(nidx):
                ioff = br.read(64)
                inum = br.read(8)
                br.read(3 * 8)
                idxs.append(CueSheetTrackIndex(ioff, inum))
            tracks.append(CueSheetTrack(offset, number, isrc, ttype == 0,
                                        bool(pre), idxs))
        return cls(mcn, lead_in, is_cd, tracks)

    def to_bytes(self) -> bytes:
        bw = BitWriter()
        bw.write_bytes(self.media_catalog_number[:128].ljust(128, b"\x00"))
        bw.write(self.lead_in, 64)
        bw.write(1 if self.is_cd else 0, 1)
        bw.write(0, 7)
        bw.write_bytes(b"\x00" * 258)
        bw.write(len(self.tracks), 8)
        for t in self.tracks:
            bw.write(t.offset, 64)
            bw.write(t.number, 8)
            bw.write_bytes(t.isrc[:12].ljust(12, b"\x00"))
            bw.write(0 if t.is_audio else 1, 1)
            bw.write(1 if t.pre_emphasis else 0, 1)
            bw.write(0, 6)
            bw.write_bytes(b"\x00" * 13)
            bw.write(len(t.indices), 8)
            for ix in t.indices:
                bw.write(ix.offset, 64)
                bw.write(ix.number, 8)
                bw.write_bytes(b"\x00" * 3)
        return bw.getvalue()


@dataclass
class PictureBlock:
    picture_type: int = 3  # front cover
    mime_type: str = "image/png"
    description: str = ""
    width: int = 0
    height: int = 0
    depth: int = 0
    colors: int = 0
    data: bytes = b""
    TYPE = fmt.METADATA_TYPE_PICTURE

    @classmethod
    def from_specification(cls, spec: str) -> "PictureBlock":
        """grabbag picture-spec parser (picture.c:515
        grabbag__picture_parse_specification):
        ``[TYPE]|MIME|[DESCRIPTION]|[WIDTHxHEIGHTxDEPTH[/COLORS]]|FILE``
        or a bare file path.  MIME ``-->`` makes FILE a URL stored as
        text.  PNG/JPEG/GIF dimensions are probed from the file when the
        dims part is empty where cheaply possible."""
        parts = spec.split("|")
        if len(parts) == 5:
            tpart, mime, desc, dims, fname = parts
            ptype = int(tpart) if tpart else 3
        elif len(parts) == 1:
            ptype, mime, desc, dims, fname = 3, "", "", "", spec
        else:
            raise MetadataError(
                "picture specification must have 5 '|'-separated parts "
                "or be a bare file path")
        if mime == "-->":
            data = fname.encode("ascii")
        else:
            data = open(fname, "rb").read()
            if not mime:
                if data[:8] == b"\x89PNG\r\n\x1a\n":
                    mime = "image/png"
                elif data[:3] == b"GIF":
                    mime = "image/gif"
                else:
                    mime = "image/jpeg"
        pic = cls(picture_type=ptype, mime_type=mime, description=desc,
                  data=data)
        if dims:
            wh, _, colors = dims.partition("/")
            w, h, d = (wh.split("x") + ["0", "0", "0"])[:3]
            pic.width, pic.height, pic.depth = int(w), int(h), int(d)
            pic.colors = int(colors) if colors else 0
        elif mime == "image/png" and len(data) >= 26:
            pic.width = struct.unpack(">I", data[16:20])[0]
            pic.height = struct.unpack(">I", data[20:24])[0]
            pic.depth = data[24]
        if ptype in (1, 2) and mime not in ("image/png", "-->"):
            raise MetadataError(
                "icon picture types (1, 2) must be PNG or URL")
        return pic

    @classmethod
    def parse(cls, body: bytes) -> "PictureBlock":
        pos = 0

        def u32():
            nonlocal pos
            v = struct.unpack(">I", body[pos:pos + 4])[0]
            pos += 4
            return v
        ptype = u32()
        mlen = u32(); mime = body[pos:pos + mlen].decode("ascii", "replace")
        pos += mlen
        dlen = u32(); desc = body[pos:pos + dlen].decode("utf-8", "replace")
        pos += dlen
        w, h, d, c = u32(), u32(), u32(), u32()
        dsz = u32()
        return cls(ptype, mime, desc, w, h, d, c, body[pos:pos + dsz])

    def to_bytes(self) -> bytes:
        m = self.mime_type.encode("ascii")
        d = self.description.encode("utf-8")
        return (struct.pack(">I", self.picture_type)
                + struct.pack(">I", len(m)) + m
                + struct.pack(">I", len(d)) + d
                + struct.pack(">IIII", self.width, self.height, self.depth,
                              self.colors)
                + struct.pack(">I", len(self.data)) + self.data)


@dataclass
class UnknownBlock:
    block_type: int = 126
    data: bytes = b""

    @property
    def TYPE(self):  # noqa: N802
        return self.block_type

    @classmethod
    def parse(cls, body: bytes, block_type: int = 126) -> "UnknownBlock":
        return cls(block_type=block_type, data=body)

    def to_bytes(self) -> bytes:
        return self.data


_PARSERS = {
    fmt.METADATA_TYPE_STREAMINFO: StreamInfoBlock.parse,
    fmt.METADATA_TYPE_PADDING: PaddingBlock.parse,
    fmt.METADATA_TYPE_APPLICATION: ApplicationBlock.parse,
    fmt.METADATA_TYPE_SEEKTABLE: SeekTableBlock.parse,
    fmt.METADATA_TYPE_VORBIS_COMMENT: VorbisCommentBlock.parse,
    fmt.METADATA_TYPE_CUESHEET: CueSheetBlock.parse,
    fmt.METADATA_TYPE_PICTURE: PictureBlock.parse,
}


def parse_block(block_type: int, body: bytes):
    p = _PARSERS.get(block_type)
    if p is None:
        return UnknownBlock.parse(body, block_type)
    return p(body)


def parse_metadata_blocks(data: bytes) -> list[tuple[int, bytes]]:
    """Raw (type, body) pairs of a FLAC stream's metadata section."""
    if data[:4] != fmt.STREAM_SYNC_STRING:
        raise MetadataError("missing fLaC marker")
    out = []
    pos, last = 4, False
    while not last:
        if pos + 4 > len(data):
            raise MetadataError("truncated metadata")
        hdr = struct.unpack(">I", data[pos:pos + 4])[0]
        last = bool(hdr >> 31)
        btype = (hdr >> 24) & 0x7F
        length = hdr & 0xFFFFFF
        body = data[pos + 4:pos + 4 + length]
        if len(body) != length:
            raise MetadataError("truncated metadata block")
        out.append((btype, body))
        pos += 4 + length
    return out


def block_header(block_type: int, length: int, is_last: bool) -> bytes:
    return struct.pack(">I", ((1 if is_last else 0) << 31)
                       | (block_type << 24) | length)


class Chain:
    """Level-2 metadata editor: read all blocks, edit, write back.

    Writing reuses/resizes trailing PADDING when the new metadata fits
    (the reference's in-place path, metadata_iterators.c chain_write);
    otherwise the whole file is rewritten.
    """

    def __init__(self):
        self.blocks: list = []
        self._frames: bytes | None = b""
        self._meta_bytes: int = 0
        self._src_path: str | None = None   # lazy file mode (read_file)

    @classmethod
    def read(cls, data: bytes) -> "Chain":
        if data[:4] != fmt.STREAM_SYNC_STRING:
            raise MetadataError("missing fLaC marker")
        ch = cls()
        pos = 4
        last = False
        while not last:
            if pos + 4 > len(data):
                raise MetadataError("truncated metadata")
            hdr = struct.unpack(">I", data[pos:pos + 4])[0]
            last = bool(hdr >> 31)
            btype = (hdr >> 24) & 0x7F
            length = hdr & 0xFFFFFF
            body = data[pos + 4:pos + 4 + length]
            if len(body) != length:
                raise MetadataError("truncated metadata block")
            try:
                ch.blocks.append(parse_block(btype, body))
            except (IndexError, struct.error, OverflowError,
                    UnicodeDecodeError) as e:
                raise MetadataError(f"corrupt metadata block: {e}") from e
            pos += 4 + length
        ch._frames = data[pos:]
        ch._meta_bytes = pos - 4
        return ch

    @classmethod
    def read_file(cls, path: str) -> "Chain":
        """Lazy file mode: parse only the metadata section (headers +
        bodies — KBs, not the audio).  The frames stay on disk;
        write_file() patches the metadata region in place when the new
        section is the same size (the common padding-reuse case), and
        shifts the tail through a chunked temp-file copy otherwise —
        so a tag edit on a multi-GB file is O(metadata), not O(file)
        (the reference's metadata_iterators.c chain write-with-padding
        behavior)."""
        with open(path, "rb") as f:
            if f.read(4) != fmt.STREAM_SYNC_STRING:
                raise MetadataError("missing fLaC marker")
            ch = cls()
            pos, last = 4, False
            while not last:
                hdr_b = f.read(4)
                if len(hdr_b) != 4:
                    raise MetadataError("truncated metadata")
                hdr = struct.unpack(">I", hdr_b)[0]
                last = bool(hdr >> 31)
                btype = (hdr >> 24) & 0x7F
                length = hdr & 0xFFFFFF
                body = f.read(length)
                if len(body) != length:
                    raise MetadataError("truncated metadata block")
                try:
                    ch.blocks.append(parse_block(btype, body))
                except (IndexError, struct.error, OverflowError,
                        UnicodeDecodeError) as e:
                    raise MetadataError(
                        f"corrupt metadata block: {e}") from e
                pos += 4 + length
        ch._frames = None
        ch._meta_bytes = pos - 4
        ch._src_path = path
        return ch

    def get(self, block_type: int):
        for b in self.blocks:
            if b.TYPE == block_type:
                return b
        return None

    @property
    def streaminfo(self) -> StreamInfoBlock:
        si = self.get(fmt.METADATA_TYPE_STREAMINFO)
        if si is None:
            raise MetadataError("no STREAMINFO")
        return si

    def sort_padding(self) -> None:
        """Merge all padding into one block at the end
        (metaflac --sort-padding)."""
        total = sum(b.length for b in self.blocks
                    if isinstance(b, PaddingBlock))
        self.blocks = [b for b in self.blocks
                       if not isinstance(b, PaddingBlock)]
        if total:
            self.blocks.append(PaddingBlock(total))

    def _serialize(self, use_padding: bool = True) -> bytes:
        out = bytearray(fmt.STREAM_SYNC_STRING)
        bodies = [(b.TYPE, b.to_bytes()) for b in self.blocks]
        if use_padding:
            # fit into the existing metadata region by resizing padding
            fixed = sum(4 + len(body) for t, body in bodies
                        if t != fmt.METADATA_TYPE_PADDING)
            room = self._meta_bytes - fixed
            bodies = [(t, body) for t, body in bodies
                      if t != fmt.METADATA_TYPE_PADDING]
            if room >= 4:
                bodies.append((fmt.METADATA_TYPE_PADDING,
                               b"\x00" * (room - 4)))
        for i, (t, body) in enumerate(bodies):
            out += block_header(t, len(body), i == len(bodies) - 1)
            out += body
        return bytes(out)

    def _meta_section(self) -> bytes:
        bodies_len = sum(4 + len(b.to_bytes()) for b in self.blocks
                         if not isinstance(b, PaddingBlock))
        if bodies_len <= self._meta_bytes - 4 or \
                any(isinstance(b, PaddingBlock) for b in self.blocks):
            return self._serialize(use_padding=bodies_len + 4
                                   <= self._meta_bytes)
        return self._serialize(use_padding=False)

    def _load_frames(self) -> bytes:
        if self._frames is None:
            with open(self._src_path, "rb") as f:
                f.seek(self._meta_bytes + 4)
                self._frames = f.read()
        return self._frames

    def write(self) -> bytes:
        """Serialize the whole stream (metadata + frames)."""
        return self._meta_section() + self._load_frames()

    def write_file(self, path: str) -> None:
        meta = self._meta_section()
        src = self._src_path
        if src is not None and os.path.exists(path) \
                and os.path.samefile(path, src):
            if len(meta) == self._meta_bytes + 4:
                # same-size metadata: patch in place, frames untouched
                with open(path, "r+b") as f:
                    f.write(meta)
                return
            # size changed: shift the tail via a chunked temp-file copy
            dir_ = os.path.dirname(os.path.abspath(path)) or "."
            fd, tmp = tempfile.mkstemp(prefix=".flacmeta.", dir=dir_)
            try:
                with os.fdopen(fd, "wb") as out, open(src, "rb") as f:
                    out.write(meta)
                    f.seek(self._meta_bytes + 4)
                    while True:
                        chunk = f.read(_CHUNK)
                        if not chunk:
                            break
                        out.write(chunk)
                os.chmod(tmp, stat.S_IMODE(os.stat(path).st_mode))
                os.replace(tmp, path)
                tmp = None
            finally:
                if tmp is not None:
                    os.unlink(tmp)
            self._meta_bytes = len(meta) - 4
            return
        with open(path, "wb") as f:
            f.write(meta)
            f.write(self._load_frames())


# ---------------------------------------------------------------------------
# Level 0 one-shot getters (metadata.h:165-246)
# ---------------------------------------------------------------------------

def get_streaminfo(path: str) -> StreamInfoBlock:
    return Chain.read_file(path).streaminfo


def get_tags(path: str) -> VorbisCommentBlock | None:
    return Chain.read_file(path).get(fmt.METADATA_TYPE_VORBIS_COMMENT)


def get_cuesheet(path: str) -> CueSheetBlock | None:
    return Chain.read_file(path).get(fmt.METADATA_TYPE_CUESHEET)


def get_picture(path: str) -> PictureBlock | None:
    return Chain.read_file(path).get(fmt.METADATA_TYPE_PICTURE)


# ---------------------------------------------------------------------------
# Level 1 — SimpleIterator (metadata.h:374-663, metadata_iterators.c
# FLAC__metadata_simple_iterator_*): forward/backward iteration over a
# file's metadata blocks with in-place editing.  The audio frames are
# never read into memory: same-size writes patch the block bytes, size
# changes are absorbed by adjacent PADDING whenever possible, and only
# when no padding can absorb the delta is the file tail shifted — via a
# chunked temp-file rewrite (the reference's own strategy for that case).
# ---------------------------------------------------------------------------

_CHUNK = 1 << 20


@dataclass
class _Entry:
    offset: int          # file offset of the 4-byte block header
    type: int
    length: int          # body length
    is_last: bool


class SimpleIterator:
    """In-place metadata editor over a FLAC file on disk.

    Mirrors the reference level-1 API: next/prev/is_last, get_block_*,
    get_block, set_block, insert_block_after, delete_block — with Python
    exceptions (MetadataError) in place of status codes.  Use as a
    context manager or call close().
    """

    def __init__(self, path: str, read_only: bool = False,
                 preserve_file_stats: bool = False):
        self.path = path
        self.read_only = read_only
        self.preserve_file_stats = preserve_file_stats
        self._f = open(path, "rb" if read_only else "r+b")
        try:
            self._walk()
        except Exception:
            self._f.close()
            raise
        self._idx = 0

    # -- lifecycle ----------------------------------------------------

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "SimpleIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- header walk --------------------------------------------------

    def _walk(self) -> None:
        """(Re)build the block table from the on-disk headers; reads only
        the 4-byte headers, seeking over every body."""
        f = self._f
        f.seek(0)
        if f.read(4) != fmt.STREAM_SYNC_STRING:
            raise MetadataError("missing fLaC marker")
        self._entries: list[_Entry] = []
        pos, last = 4, False
        while not last:
            hdr_b = f.read(4)
            if len(hdr_b) != 4:
                raise MetadataError("truncated metadata")
            hdr = struct.unpack(">I", hdr_b)[0]
            last = bool(hdr >> 31)
            e = _Entry(pos, (hdr >> 24) & 0x7F, hdr & 0xFFFFFF, last)
            self._entries.append(e)
            pos += 4 + e.length
            f.seek(pos)
        self._frames_off = pos
        if not self._entries or \
                self._entries[0].type != fmt.METADATA_TYPE_STREAMINFO:
            raise MetadataError("first block is not STREAMINFO")

    # -- navigation (metadata.h:480-520) ------------------------------

    def next(self) -> bool:
        if self._idx + 1 >= len(self._entries):
            return False
        self._idx += 1
        return True

    def prev(self) -> bool:
        if self._idx == 0:
            return False
        self._idx -= 1
        return True

    def is_last(self) -> bool:
        return self._entries[self._idx].is_last

    def is_writable(self) -> bool:
        return not self.read_only

    # -- accessors (metadata.h:528-585) -------------------------------

    def get_block_offset(self) -> int:
        return self._entries[self._idx].offset

    def get_block_type(self) -> int:
        return self._entries[self._idx].type

    def get_block_length(self) -> int:
        return self._entries[self._idx].length

    def get_application_id(self) -> bytes:
        e = self._entries[self._idx]
        if e.type != fmt.METADATA_TYPE_APPLICATION or e.length < 4:
            raise MetadataError("current block is not an APPLICATION block")
        self._f.seek(e.offset + 4)
        return self._f.read(4)

    def get_block(self):
        e = self._entries[self._idx]
        self._f.seek(e.offset + 4)
        body = self._f.read(e.length)
        if len(body) != e.length:
            raise MetadataError("truncated metadata block")
        return parse_block(e.type, body)

    # -- editing (metadata.h:594-663) ---------------------------------

    def _require_writable(self) -> None:
        if self.read_only:
            raise MetadataError("iterator is read-only")

    def _patch(self, offset: int, data: bytes) -> None:
        self._f.seek(offset)
        self._f.write(data)

    def _region(self, entries: list[_Entry]) -> tuple[int, int]:
        start = entries[0].offset
        end = entries[-1].offset + 4 + entries[-1].length
        return start, end

    def _rewrite_region(self, start: int, end: int, new: bytes) -> None:
        """Replace file bytes [start, end) with `new`, shifting the tail
        through a temp file in chunks (never holding the frames in
        memory).  The temp file takes the original's mode bits before it
        replaces it.  The cursor is not kept: callers re-walk the headers
        and re-seek by index."""
        st = os.stat(self.path) if self.preserve_file_stats else None
        f = self._f
        dir_ = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".flacmeta.", dir=dir_)
        try:
            with os.fdopen(fd, "wb") as out:
                f.seek(0)
                left = start
                while left:
                    chunk = f.read(min(_CHUNK, left))
                    if not chunk:
                        raise MetadataError("file truncated during edit")
                    out.write(chunk)
                    left -= len(chunk)
                out.write(new)
                f.seek(end)
                while True:
                    chunk = f.read(_CHUNK)
                    if not chunk:
                        break
                    out.write(chunk)
            f.close()
            os.chmod(tmp, stat.S_IMODE(os.stat(self.path).st_mode))
            os.replace(tmp, self.path)
            tmp = None
        finally:
            if tmp is not None:
                os.unlink(tmp)
        if st is not None:
            os.utime(self.path, ns=(st.st_atime_ns, st.st_mtime_ns))
        self._f = open(self.path, "r+b")

    def _serialize_entry(self, block, is_last: bool) -> bytes:
        body = block.to_bytes()
        if len(body) > 0xFFFFFF:
            raise MetadataError("metadata block body exceeds 2^24-1 bytes")
        return block_header(block.TYPE, len(body), is_last) + body

    def _apply(self, lo: int, hi: int, blocks: list, cursor: int) -> None:
        """Replace entry range [lo, hi) with `blocks` (parsed objects or
        raw (type, body) pairs), choosing in-place patch when the byte
        size matches, temp-file shift otherwise; then rewalk and place
        the cursor at new index `cursor`."""
        ents = self._entries
        if hi > lo:
            start, end = self._region(ents[lo:hi])
        else:
            # an insertion: before block lo, or after the last block
            start = end = ents[lo].offset if lo < len(ents) \
                else self._frames_off
        n_after = len(ents) - hi
        out = bytearray()
        for i, blk in enumerate(blocks):
            last = (n_after == 0) and (i == len(blocks) - 1)
            if isinstance(blk, tuple):
                t, body = blk
                out += block_header(t, len(body), last) + body
            else:
                out += self._serialize_entry(blk, last)
        if not blocks and n_after == 0 and lo > 0:
            # deleting the trailing block: previous becomes last
            p = ents[lo - 1]
            self._patch(p.offset,
                        block_header(p.type, p.length, True))
        elif blocks and lo == len(ents):
            # appending after the last block: it is last no more
            p = ents[lo - 1]
            self._patch(p.offset,
                        block_header(p.type, p.length, False))
        if len(out) == end - start:
            self._patch(start, bytes(out))
        else:
            self._rewrite_region(start, end, bytes(out))
        self._walk()
        self._idx = max(0, min(cursor, len(self._entries) - 1))

    def set_block(self, block, use_padding: bool = True) -> None:
        """Overwrite the current block (metadata.h:620).  Same-size →
        pure in-place write; shrink → trailing slack becomes/joins
        PADDING; grow → absorbed from a following PADDING block when it
        fits; otherwise the tail is shifted."""
        self._require_writable()
        i = self._idx
        e = self._entries[i]
        if i == 0 and block.TYPE != fmt.METADATA_TYPE_STREAMINFO:
            raise MetadataError("block 0 must remain STREAMINFO")
        body = block.to_bytes()
        new_sz, old_sz = 4 + len(body), 4 + e.length
        if new_sz == old_sz:
            self._patch(e.offset,
                        block_header(block.TYPE, len(body), e.is_last)
                        + body)
            self._entries[i] = _Entry(e.offset, block.TYPE, len(body),
                                      e.is_last)
            return
        nxt = self._entries[i + 1] if i + 1 < len(self._entries) else None
        if use_padding:
            if new_sz < old_sz:
                slack = old_sz - new_sz
                if nxt is not None and nxt.type == fmt.METADATA_TYPE_PADDING:
                    # grow the following padding backwards over the slack
                    pad = (fmt.METADATA_TYPE_PADDING,
                           b"\x00" * (nxt.length + slack))
                    self._apply(i, i + 2, [block, pad], i)
                    return
                if slack >= 4:
                    pad = (fmt.METADATA_TYPE_PADDING, b"\x00" * (slack - 4))
                    self._apply(i, i + 1, [block, pad], i)
                    return
            elif nxt is not None and nxt.type == fmt.METADATA_TYPE_PADDING:
                grow = new_sz - old_sz
                if nxt.length + 4 == grow:
                    self._apply(i, i + 2, [block], i)   # consume exactly
                    return
                if nxt.length >= grow:
                    pad = (fmt.METADATA_TYPE_PADDING,
                           b"\x00" * (nxt.length - grow))
                    self._apply(i, i + 2, [block, pad], i)
                    return
        self._apply(i, i + 1, [block], i)

    def insert_block_after(self, block, use_padding: bool = True) -> None:
        """Insert after the current block and move to it
        (metadata.h:643).  With use_padding, the new block is carved out
        of an immediately-following PADDING block when it fits."""
        self._require_writable()
        if block.TYPE == fmt.METADATA_TYPE_STREAMINFO:
            raise MetadataError("cannot insert a second STREAMINFO")
        i = self._idx
        body = block.to_bytes()
        need = 4 + len(body)
        nxt = self._entries[i + 1] if i + 1 < len(self._entries) else None
        if use_padding and nxt is not None \
                and nxt.type == fmt.METADATA_TYPE_PADDING:
            if nxt.length + 4 == need:
                self._apply(i + 1, i + 2, [block], i + 1)
                return
            if nxt.length >= need:
                pad = (fmt.METADATA_TYPE_PADDING,
                       b"\x00" * (nxt.length - need))
                self._apply(i + 1, i + 2, [block, pad], i + 1)
                return
        self._apply(i + 1, i + 1, [block], i + 1)

    def delete_block(self, use_padding: bool = True) -> None:
        """Delete the current block and move to the previous one
        (metadata.h:663).  With use_padding the block's bytes become a
        PADDING block (a header and a zeroed body, as PADDING is defined:
        O(block), the frames untouched), merged with an adjacent following
        PADDING when present."""
        self._require_writable()
        i = self._idx
        if i == 0:
            raise MetadataError("cannot delete STREAMINFO")
        e = self._entries[i]
        nxt = self._entries[i + 1] if i + 1 < len(self._entries) else None
        if use_padding:
            if nxt is not None and nxt.type == fmt.METADATA_TYPE_PADDING:
                pad = (fmt.METADATA_TYPE_PADDING,
                       b"\x00" * (e.length + 4 + nxt.length))
                self._apply(i, i + 2, [pad], i - 1)
            else:
                self._patch(e.offset, block_header(
                    fmt.METADATA_TYPE_PADDING, e.length, e.is_last)
                    + b"\x00" * e.length)
                self._entries[i] = _Entry(e.offset,
                                          fmt.METADATA_TYPE_PADDING,
                                          e.length, e.is_last)
                self._idx = i - 1
            return
        self._apply(i, i + 1, [], i - 1)
