"""Ogg FLAC container: page-level mux/demux of native FLAC streams.

Port of flac_tpu/ogg.py.  Host-side counterpart of libFLAC's Ogg aspects
(src/libFLAC/ogg_encoder_aspect.c:113-230 packetize/paginate,
ogg_decoder_aspect.c:96-165,603-640 demux + chained-stream links,
ogg_mapping.c constants).  The device does the frame codec; this module
only rearranges bytes, so it is pure host Python/numpy.  The decode entry
points pass their keyword arguments (device, engine, verify_md5, ...) to
decoder.decode_stream_tpu.

FLAC-in-Ogg mapping (https://xiph.org/flac/ogg_mapping.html):
  packet 0 (its own BOS page): 0x7F 'FLAC' major minor nheaders(2,BE)
      'fLaC' + STREAMINFO block (with header)
  packets 1..n: remaining metadata blocks, one per packet
  then one FLAC frame per packet; page granulepos = number of the last
  sample contained in the last packet completed on that page.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from . import format as fmt
from .decoder import decode_stream_tpu, parse_frame_header, \
    parse_metadata, scan_frames

MAPPING_VERSION = (1, 0)
_MAGIC = b"OggS"

# Ogg CRC-32: poly 0x04c11db7, init 0, not reflected, no final xor
_CRC_TABLE = np.zeros(256, np.uint32)
for _i in range(256):
    _c = _i << 24
    for _ in range(8):
        _c = ((_c << 1) ^ 0x04C11DB7 if _c & 0x80000000 else _c << 1) \
            & 0xFFFFFFFF
    _CRC_TABLE[_i] = _c


def crc32_ogg(data: bytes) -> int:
    crc = 0
    tab = _CRC_TABLE
    for b in data:
        crc = ((crc << 8) ^ int(tab[((crc >> 24) ^ b) & 0xFF])) & 0xFFFFFFFF
    return crc


class OggError(ValueError):
    pass


@dataclass
class OggPage:
    header_type: int
    granulepos: int
    serial: int
    sequence: int
    segments: list  # list[bytes] lacing-value chunks
    continued_out: bool = False

    def to_bytes(self) -> bytes:
        lacing = b"".join(bytes([len(s)]) for s in self.segments)
        body = b"".join(self.segments)
        hdr = bytearray()
        hdr += _MAGIC
        hdr.append(0)                       # version
        hdr.append(self.header_type)
        hdr += (self.granulepos & (1 << 64) - 1).to_bytes(8, "little")
        hdr += self.serial.to_bytes(4, "little")
        hdr += self.sequence.to_bytes(4, "little")
        hdr += b"\x00\x00\x00\x00"          # crc placeholder
        hdr.append(len(self.segments))
        page = bytes(hdr) + lacing + body
        crc = crc32_ogg(page)
        return page[:22] + crc.to_bytes(4, "little") + page[26:]


class PageWriter:
    """Packet -> page assembler (ogg_encoder_aspect.c write path)."""

    def __init__(self, out, serial: int):
        self.out = out
        self.serial = serial & 0xFFFFFFFF
        self.sequence = 0
        self._segments: list[bytes] = []
        self._continued = False
        self._bos_pending = True
        # granulepos of the last packet COMPLETED on the current page;
        # -1 while no packet has ended on it (ogg_encoder_aspect.c:202-228
        # semantics: -1 is reserved for pages where no packet ends)
        self._page_granulepos = -1

    def _flush_page(self, granulepos: int, *, eos: bool = False,
                    next_continued: bool = False):
        htype = ((0x01 if self._continued else 0)
                 | (0x02 if self._bos_pending else 0)
                 | (0x04 if eos else 0))
        page = OggPage(htype, granulepos, self.serial, self.sequence,
                       self._segments)
        self.out.write(page.to_bytes())
        self.sequence += 1
        self._segments = []
        self._continued = next_continued
        self._bos_pending = False
        self._page_granulepos = -1

    def write_packet(self, data: bytes, granulepos: int = -1, *,
                     flush: bool = False, eos: bool = False):
        """Append one packet; its granulepos stamps whichever page it
        completes on (or the forced flush below).

        flush forces a page boundary after this packet (the mapping requires
        the first header packet alone on the BOS page).
        """
        pos = 0
        while True:
            seg = data[pos:pos + 255]
            self._segments.append(seg)
            pos += len(seg)
            ends_here = pos >= len(data) and len(seg) < 255
            if ends_here:
                self._page_granulepos = granulepos
            if len(self._segments) == 255:
                # page full: stamp the last packet completed on it (-1 only
                # when the whole page is mid-packet)
                self._flush_page(self._page_granulepos,
                                 next_continued=not ends_here)
            if len(seg) < 255:
                break
        if flush or eos:
            self.flush(eos=eos)

    def flush(self, *, eos: bool = False):
        if self._segments or eos:
            self._flush_page(self._page_granulepos, eos=eos)


def read_pages(data: bytes, start: int = 0):
    """Iterate (page_dict, end_offset) over an Ogg byte stream."""
    pos = start
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != _MAGIC:
            # resync: scan for capture pattern (decoder aspect tolerance)
            nxt = data.find(_MAGIC, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        if data[pos + 4] != 0:
            raise OggError("unsupported Ogg version")
        htype = data[pos + 5]
        granule = int.from_bytes(data[pos + 6:pos + 14], "little")
        serial = int.from_bytes(data[pos + 14:pos + 18], "little")
        seq = int.from_bytes(data[pos + 18:pos + 22], "little")
        crc_stored = int.from_bytes(data[pos + 22:pos + 26], "little")
        nseg = data[pos + 26]
        lace = data[pos + 27:pos + 27 + nseg]
        if len(lace) < nseg:
            return
        body_len = sum(lace)
        end = pos + 27 + nseg + body_len
        if end > n:
            return
        page = data[pos:end]
        if crc32_ogg(page[:22] + b"\x00\x00\x00\x00" + page[26:]) \
                != crc_stored:
            pos += 1
            continue
        body = page[27 + nseg:]
        segs, o = [], 0
        for lv in lace:
            segs.append(body[o:o + lv])
            o += lv
        yield dict(header_type=htype, granulepos=granule, serial=serial,
                   sequence=seq, lacing=list(lace), segments=segs), end
        pos = end


def pages_to_packets(pages):
    """Reassemble packets per serial from an in-order page iterator."""
    partial: dict[int, bytearray] = {}
    for page in pages:
        serial = page["serial"]
        buf = partial.setdefault(serial, bytearray())
        pairs = list(zip(page["lacing"], page["segments"]))
        if not (page["header_type"] & 0x01):
            buf.clear()
        elif not buf:
            # resync landed on a continued page with no pending partial:
            # the packet's head is lost, so drop its remaining segments
            # (up to and including the first lacing value < 255)
            while pairs and pairs[0][0] == 255:
                pairs.pop(0)
            if pairs:
                pairs.pop(0)
        for lv, seg in pairs:
            buf += seg
            if lv < 255:
                yield serial, bytes(buf), page
                buf.clear()
    # a final packet without a terminating lacing value is dropped
    # (truncated stream), matching the reference's EOS behavior


# ---------------------------------------------------------------------------
# FLAC-in-Ogg encode
# ---------------------------------------------------------------------------

def _build_header_pages(meta: bytes, serial: int) -> bytes:
    """Packetize a native FLAC metadata region (fLaC..last block) into
    the Ogg FLAC header pages (mapping packet 0 + one packet per block).
    Deterministic: rebuilding after a STREAMINFO/seektable backpatch
    yields byte-identical page framing."""
    if meta[:4] != fmt.STREAM_SYNC_STRING:
        raise OggError("not a FLAC stream")
    blocks = []
    pos = 4
    while True:
        hdr = meta[pos:pos + 4]
        is_last = hdr[0] >> 7
        size = int.from_bytes(hdr[1:4], "big")
        blocks.append((pos, 4 + size))
        pos += 4 + size
        if is_last:
            break
    buf = io.BytesIO()
    w = PageWriter(buf, serial)
    nheaders = len(blocks)  # includes STREAMINFO; stored as count-1 extra
    first = bytearray()
    first += bytes([0x7F]) + b"FLAC"
    first += bytes(MAPPING_VERSION)
    first += (nheaders - 1).to_bytes(2, "big")
    first += fmt.STREAM_SYNC_STRING
    b0_off, b0_size = blocks[0]
    # STREAMINFO must be marked non-last inside Ogg when more headers follow
    blk = bytearray(meta[b0_off:b0_off + b0_size])
    blk[0] = (blk[0] & 0x7F) | (0x80 if nheaders == 1 else 0)
    first += blk
    w.write_packet(bytes(first), 0, flush=True)
    for i, (off, size) in enumerate(blocks[1:], 1):
        blk = bytearray(meta[off:off + size])
        blk[0] = (blk[0] & 0x7F) | (0x80 if i == nheaders - 1 else 0)
        w.write_packet(bytes(blk), 0, flush=(i == nheaders - 1))
    return buf.getvalue(), w.sequence, pos


class OggFlacSink:
    """Incremental Ogg FLAC encode sink (ogg_encoder_aspect.c:113-230).

    File-like target for StreamEncoder: pages stream out as frame
    batches land, so peak memory is independent of input length (the
    round-3 wrapper buffered the whole FLAC stream first).

      - header phase: metadata written via write() accumulates until the
        last-block flag, then is packetized into the header pages;
      - audio phase: write_frames(blob, lens, nsamples) pages one packet
        per frame; the final packet is held back so the EOS flag lands
        on the true last page at finalize();
      - backpatch: StreamEncoder.finish()'s seek+write of the resolved
        STREAMINFO/seektable mutates the retained metadata bytes and the
        header pages are rewritten in place (size-preserving, CRCs
        recomputed) when the real output is seekable.

    tell() reports positions in NATIVE FLAC byte space so the encoder's
    seektable offset arithmetic is container-independent.
    """

    def __init__(self, out, *, serial: int = 0x464C4143):
        self.out = out
        self.serial = serial & 0xFFFFFFFF
        self._meta = bytearray()
        self._meta_len = None          # set once the last block is seen
        self._header_out_off = None    # offset of header pages in out
        self._header_len = 0
        self._w = PageWriter(out, self.serial)
        self._flac_pos = 0             # audio-phase position (flac space)
        self._samples = 0
        self._pending = None           # (frame_bytes, nsamples) held packet
        self._patch_pos = None
        self._dirty = False
        self._finalized = False

    # -- file-like surface used by StreamEncoder ------------------------
    def seekable(self) -> bool:
        try:
            return self.out.seekable()
        except AttributeError:
            return False

    def tell(self) -> int:
        if self._meta_len is None:
            return len(self._meta)
        if self._patch_pos is not None:
            return self._patch_pos
        return self._flac_pos

    def write(self, b: bytes) -> int:
        if self._patch_pos is not None:
            end = self._patch_pos + len(b)
            if end > self._meta_len:
                raise OggError("backpatch write outside the header region")
            self._meta[self._patch_pos:end] = b
            self._patch_pos = end
            self._dirty = True
            return len(b)
        if self._meta_len is not None:
            raise OggError("raw writes after the header phase "
                           "(use write_frames)")
        self._meta += b
        self._try_finish_header()
        return len(b)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 2:
            pos = self._flac_pos + pos
        if self._meta_len is not None and pos < self._meta_len:
            self._patch_pos = pos
            return pos
        # leaving the patch region: rewrite dirty header pages in place
        if self._dirty and self._header_out_off is not None:
            pages, _seq, _mlen = _build_header_pages(bytes(self._meta),
                                                     self.serial)
            assert len(pages) == self._header_len, \
                "backpatch changed header page size (encoder bug)"
            cur = self.out.tell()
            self.out.seek(self._header_out_off)
            self.out.write(pages)
            self.out.seek(cur)
            self._dirty = False
        self._patch_pos = None
        return pos

    # -- header/audio phases --------------------------------------------
    def _try_finish_header(self):
        if len(self._meta) < 8 or self._meta[:4] != fmt.STREAM_SYNC_STRING:
            return
        pos = 4
        while pos + 4 <= len(self._meta):
            hdr = self._meta[pos:pos + 4]
            size = int.from_bytes(hdr[1:4], "big")
            if pos + 4 + size > len(self._meta):
                return                     # block body incomplete
            pos += 4 + size
            if hdr[0] >> 7:                # last-metadata flag
                if pos != len(self._meta):
                    raise OggError("bytes past the last metadata block")
                pages, seq, mlen = _build_header_pages(
                    bytes(self._meta), self.serial)
                self._meta_len = mlen
                self._header_out_off = (self.out.tell()
                                        if self.seekable() else None)
                self._header_len = len(pages)
                self.out.write(pages)
                # audio pages continue the page sequence after the header
                self._w.sequence = seq
                self._w._bos_pending = False
                self._flac_pos = mlen
                return

    def write_frames(self, blob, lens, nsamples) -> None:
        """One batch of frames: blob concatenates len(lens) frames whose
        i-th byte length is lens[i] and sample count nsamples[i] (scalar
        = uniform)."""
        if self._meta_len is None:
            raise OggError("write_frames before the header completed")
        off = 0
        n = len(lens)
        for i in range(n):
            ln = int(lens[i])
            ns = int(nsamples if np.isscalar(nsamples) else nsamples[i])
            frame = bytes(blob[off:off + ln])
            off += ln
            if self._pending is not None:
                pb, pn = self._pending
                self._samples += pn
                self._w.write_packet(pb, self._samples)
            self._pending = (frame, ns)
        self._flac_pos += off

    def finalize(self) -> None:
        """Emit the held-back last packet with EOS and flush."""
        if self._finalized:
            return
        self._finalized = True
        if self._pending is not None:
            pb, pn = self._pending
            self._samples += pn
            self._pending = None
            self._w.write_packet(pb, self._samples, eos=True)
        else:
            self._w.flush(eos=True)

    def close(self):
        self.finalize()


def wrap_flac_stream(flac: bytes, out, *, serial: int = 0x464C4143):
    """Wrap a complete native FLAC stream into Ogg FLAC (one-shot path;
    the streaming encode path uses OggFlacSink directly).

    Splits the stream at metadata-block and frame boundaries (native
    scanner) and re-emits per the mapping.  The granulepos of each audio
    page is the last sample number it completes.
    """
    sink = OggFlacSink(out, serial=serial)
    st, _ = parse_metadata(flac, 4)
    pos = _build_header_pages(flac, serial)[2]
    sink.write(flac[:pos])
    frames = scan_frames(flac, st, pos)
    if frames:
        lens = [f["size"] for f in frames]
        blob = flac[frames[0]["offset"]:frames[-1]["offset"]
                    + frames[-1]["size"]]
        # granulepos chain from the first frame's own numbering
        first = frames[0]
        sink._samples = (first["number"] if first["variable"]
                         else first["number"] * st.min_blocksize)
        sink.write_frames(blob, lens, [f["blocksize"] for f in frames])
    sink.finalize()


# ---------------------------------------------------------------------------
# FLAC-in-Ogg decode
# ---------------------------------------------------------------------------

@dataclass
class OggFlacLink:
    serial: int
    flac: bytes          # reconstructed native FLAC stream
    total_samples: int = 0
    head_len: int = 0    # bytes of metadata before the first frame
    frame_offsets: list | None = None   # per-frame byte offsets into flac


def unwrap_ogg_flac(data: bytes) -> list[OggFlacLink]:
    """Demux Ogg FLAC (including chained streams) into native FLAC links.

    Chained-stream link detection follows ogg_decoder_aspect.c:603-640: a
    BOS page after an EOS page starts a new link.
    """
    links: list[OggFlacLink] = []
    cur: bytearray | None = None
    cur_serial = None
    headers_left = 0
    last_granule = 0
    pages = (p for p, _ in read_pages(data))
    for serial, packet, page in pages_to_packets(pages):
        if (len(packet) >= 9 and packet[0] == 0x7F
                and packet[1:5] == b"FLAC"):
            if cur is not None:
                links.append(OggFlacLink(cur_serial, bytes(cur),
                                         last_granule,
                                         head_len if head_len is not None
                                         else len(cur), frame_offs))
            if packet[5] != MAPPING_VERSION[0]:
                raise OggError(f"unsupported mapping version {packet[5]}")
            headers_left = int.from_bytes(packet[7:9], "big")
            # a count of 0 means "unknown" (ogg_mapping): keep consuming
            # metadata packets (trusting their embedded last-flags) until
            # one carries the last-metadata bit
            headers_unknown = headers_left == 0
            body = packet[9:]
            if body[:4] != fmt.STREAM_SYNC_STRING:
                raise OggError("bad first header packet")
            cur = bytearray(body)
            cur_serial = serial
            head_len, frame_offs = None, []
            # fix STREAMINFO's last-metadata-block flag for the rebuilt
            # native stream: last iff no more header packets follow
            if headers_left:
                cur[4] &= 0x7F
            elif headers_unknown:
                headers_left = 0 if (cur[4] & 0x80) else -1
            else:
                cur[4] |= 0x80
            continue
        if cur is None or serial != cur_serial:
            continue  # non-FLAC logical stream: skip
        if headers_left == -1:
            # unknown header count: every non-frame packet is metadata
            if packet and packet[0] != 0xFF:
                blk = bytearray(packet)
                if blk[0] & 0x80:
                    headers_left = 0
                cur += blk
                continue
            # malformed (frame before a last-flagged block): fall through
            headers_left = 0
        if headers_left > 0:
            blk = bytearray(packet)
            headers_left -= 1
            blk[0] = (blk[0] & 0x7F) | (0 if headers_left else 0x80)
            cur += blk
            continue
        if head_len is None:
            head_len = len(cur)
        frame_offs.append(len(cur))
        cur += packet
        if page["granulepos"] != (1 << 64) - 1:
            last_granule = page["granulepos"]
    if cur is not None:
        links.append(OggFlacLink(cur_serial, bytes(cur), last_granule,
                                 head_len if head_len is not None
                                 else len(cur), frame_offs))
    if not links:
        raise OggError("no Ogg FLAC stream found")
    return links


def is_ogg(data: bytes) -> bool:
    return data[:4] == _MAGIC


def decode_ogg_flac_range(data: bytes, start_sample: int, n_samples: int,
                          **kw):
    """Ranged Ogg FLAC decode (the seek path the reference implements in
    ogg_decoder_aspect.c/ogg_helper.c): only the frame packets covering
    [start_sample, start_sample + n_samples) are decoded.

    Ogg FLAC packets map 1:1 to frames, so the packet index built during
    demux gives exact frame boundaries; the selected frames plus the
    metadata head form a valid native stream (the strict scanner accepts
    any first frame number).  Returns a DecodedStream whose samples are
    exactly the requested range of the FIRST link.
    """
    link = unwrap_ogg_flac(data)[0]
    st0, _ = parse_metadata(link.flac, 4)
    offs = link.frame_offsets or []
    # sample start of each frame from its header (fixed-blocksize streams
    # carry the frame number, variable carry the sample number)
    starts, sizes = [], []
    for o in offs:
        h = parse_frame_header(link.flac, o, st0)
        if h is None:
            raise OggError(f"bad frame packet at offset {o}")
        # fixed-blocksize frames are numbered by frame index; position
        # uses the STREAM blocksize (the last partial frame is shorter)
        starts.append(h["number"] * (1 if h["variable"]
                                     else st0.min_blocksize))
        sizes.append(h["blocksize"])
    end_sample = start_sample + n_samples
    sel = [i for i in range(len(offs))
           if starts[i] + sizes[i] > start_sample
           and starts[i] < end_sample]
    if not sel:
        st = decode_stream_tpu(link.flac, verify_md5=False, **kw)
        st.samples = st.samples[:, :0]
        return st
    sub = link.flac[:link.head_len] + b"".join(
        link.flac[offs[i]:offs[i] + (
            offs[i + 1] - offs[i] if i + 1 < len(offs)
            else len(link.flac) - offs[i])]
        for i in sel)
    st = decode_stream_tpu(sub, verify_md5=False, **kw)
    lo = start_sample - starts[sel[0]]
    st.samples = st.samples[:, lo:lo + n_samples]
    return st


def decode_ogg_flac(data: bytes, **kw):
    """Decode (possibly chained) Ogg FLAC; returns a DecodedStream with the
    links' PCM concatenated when parameters match (flac CLI behavior)."""
    links = unwrap_ogg_flac(data)
    streams = [decode_stream_tpu(l.flac, **kw) for l in links]
    first = streams[0]
    for s in streams[1:]:
        if (s.sample_rate, s.channels, s.bits_per_sample) != \
                (first.sample_rate, first.channels, first.bits_per_sample):
            raise OggError("chained links have differing stream parameters")
        first.samples = np.concatenate([first.samples, s.samples], axis=1)
        first.total_samples += s.total_samples
    return first
