"""flac_tpu_torch.metadata and .cuesheet against flac_tpu's, on the CPU.

Every block type's parse and to_bytes, Chain edits and SimpleIterator
edits give flac_tpu's bytes on the same input.  The inputs are the cases
of tests/test_metadata.py and tests/test_cuesheet.py, on streams the
port's encoder writes.  The metaflac command-line cases wait for the
port of metaflac_cli.

The port fixes four faults of flac_tpu's metadata module on purpose.
Each has a test below that shows the two results side by side:
  - insert_block_after on the last block raises IndexError in flac_tpu
    and appends in the port;
  - a temp-file rewrite leaves flac_tpu's file at mode 0600 and keeps the
    port's file mode;
  - delete_block(use_padding=True) with no PADDING after it leaves the
    deleted body on disk in flac_tpu and zeroes it in the port;
  - _rewrite_region's unused keep_offset parameter is gone.
No flac_tpu stream is encoded here, so nothing compiles.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from flac_tpu import cuesheet as jcue
from flac_tpu import metadata as jmd
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch import cuesheet as cue
from flac_tpu_torch import format as fmt
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import encode_file_to_flac

from conftest import make_test_signal

torch.set_num_threads(1)

PCM = make_test_signal(8192)


def _stream(tags=(), padding=4096, apps=()):
    """The port's -2 stream of PCM, with a VORBIS_COMMENT of `tags` (when
    given) and APPLICATION blocks (app_id, data) after it."""
    extra = []
    if tags:
        vc = md.VorbisCommentBlock()
        vc.comments.extend(tags)
        extra.append((vc.TYPE, vc.to_bytes()))
    for app_id, data in apps:
        extra.append((fmt.METADATA_TYPE_APPLICATION, app_id + data))
    return encode_file_to_flac(PCM, EncoderConfig.from_preset(2),
                               device="cpu", padding=padding,
                               extra_metadata=extra)


def _decodes(data: bytes):
    st = ref_decode(data, engine="host")
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, PCM)


def _pair(tmp_path, data: bytes, mode: int = 0o644):
    """Two copies of one file, one for each package."""
    paths = []
    for name in ("ref", "port"):
        p = tmp_path / f"{name}.flac"
        p.write_bytes(data)
        os.chmod(p, mode)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# block objects
# ---------------------------------------------------------------------------

def _blocks(pkg):
    P = pkg.SeekPoint
    return {
        "streaminfo": pkg.StreamInfoBlock(4096, 4096, 14, 9000, 44100, 2,
                                          16, 123456789, bytes(range(16))),
        "padding": pkg.PaddingBlock(37),
        "application": pkg.ApplicationBlock(b"xmpl", b"hello world"),
        "seektable": pkg.SeekTableBlock(points=[
            P(0, 0, 4096), P(44100, 1234, 4096),
            P(fmt.SEEKPOINT_PLACEHOLDER, 0, 0)]),
        "vorbis_comment": pkg.VorbisCommentBlock(
            vendor="v", comments=["TITLE=Test", "ARTIST=Ünïcode", "X="]),
        "cuesheet": pkg.CueSheetBlock(
            media_catalog_number=b"1234567890123".ljust(128, b"\x00"),
            lead_in=88200, is_cd=True,
            tracks=[pkg.CueSheetTrack(
                offset=0, number=1, isrc=b"ABCDE1234567", is_audio=True,
                pre_emphasis=True,
                indices=[pkg.CueSheetTrackIndex(0, 0),
                         pkg.CueSheetTrackIndex(588, 1)]),
                pkg.CueSheetTrack(offset=44100 * 60, number=170)]),
        "picture": pkg.PictureBlock(picture_type=3, mime_type="image/png",
                                    description="cövër", width=2, height=2,
                                    depth=24, colors=0,
                                    data=b"\x89PNG fake"),
        "unknown": pkg.UnknownBlock(block_type=99, data=b"\x01\x02\x03"),
    }


BLOCKS = list(_blocks(md))


@pytest.mark.parametrize("kind", BLOCKS)
def test_block_bytes_and_parse_match(kind):
    port, ref = _blocks(md)[kind], _blocks(jmd)[kind]
    body = ref.to_bytes()
    assert port.to_bytes() == body
    assert port.TYPE == ref.TYPE
    got = md.parse_block(port.TYPE, body)
    want = jmd.parse_block(ref.TYPE, body)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_bytes() == body
    assert md.block_header(port.TYPE, len(body), True) == \
        jmd.block_header(ref.TYPE, len(body), True)


def test_vorbis_comment_ops_match():
    out = []
    for pkg in (jmd, md):
        vc = pkg.VorbisCommentBlock()
        vc.set("GENRE", "noise")
        vc.set("genre", "drone", replace_all=True)
        vc.set("GENRE", "both", replace_all=False)
        got = [vc.get("GENRE"), vc.remove("GENRE"), vc.get("GENRE")]
        vc.set("A", "1")
        out.append((got, vc.to_bytes()))
    assert out[0] == out[1]
    assert out[1][0] == [["drone", "both"], 2, []]


def test_seektable_legal_and_templates_match():
    for kind in ("legal", "unordered"):
        pts = [(0, 0, 4096), (44100, 1234, 4096),
               (fmt.SEEKPOINT_PLACEHOLDER, 0, 0)] if kind == "legal" else \
            [(100, 0, 0), (50, 0, 0)]
        a = md.SeekTableBlock(points=[md.SeekPoint(*p) for p in pts])
        b = jmd.SeekTableBlock(points=[jmd.SeekPoint(*p) for p in pts])
        assert a.is_legal() == b.is_legal() == (kind == "legal")
    for args in ((0, 44100, 1.0), (441000, 44100, 2.5), (10, 8000, 0.0)):
        assert md.SeekTableBlock.template_spaced(*args).to_bytes() == \
            jmd.SeekTableBlock.template_spaced(*args).to_bytes()
    for args in ((4,), (5, 1000), (3, 7)):
        assert md.SeekTableBlock.template_count(*args).to_bytes() == \
            jmd.SeekTableBlock.template_count(*args).to_bytes()


@pytest.mark.parametrize("spec", [
    "{png}", "|image/png|desc|3x4x24/2|{png}", "4|-->|link||http://x/y.png",
    "3||plain||{jpg}"])
def test_picture_specification_matches(tmp_path, spec):
    png = tmp_path / "p.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 8
                    + (7).to_bytes(4, "big") + (9).to_bytes(4, "big")
                    + b"\x08rest")
    jpg = tmp_path / "p.jpg"
    jpg.write_bytes(b"\xff\xd8jpeg")
    spec = spec.format(png=png, jpg=jpg)
    assert md.PictureBlock.from_specification(spec).to_bytes() == \
        jmd.PictureBlock.from_specification(spec).to_bytes()


def test_picture_specification_errors_match():
    for spec in ("a|b", "1|image/jpeg|||x"):
        errs = []
        for pkg in (jmd, md):
            with pytest.raises(pkg.MetadataError) as e:
                pkg.PictureBlock.from_specification(
                    spec.replace("x", "/dev/null"))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_parse_metadata_blocks_matches():
    data = _stream(tags=["A=1"], apps=[(b"xmpl", b"zz")])
    assert md.parse_metadata_blocks(data) == jmd.parse_metadata_blocks(data)
    for bad in (b"OggS" + data[4:], data[:60]):
        with pytest.raises(md.MetadataError):
            md.parse_metadata_blocks(bad)
        with pytest.raises(jmd.MetadataError):
            jmd.parse_metadata_blocks(bad)


# ---------------------------------------------------------------------------
# Chain (level 2)
# ---------------------------------------------------------------------------

def _chain_edits():
    def unchanged(pkg, ch):
        pass

    def insert_tags(pkg, ch):
        vc = pkg.VorbisCommentBlock()
        vc.set("TITLE", "Test Track")
        vc.set("ARTIST", "flac_tpu")
        ch.blocks.insert(1, vc)

    def fits_padding(pkg, ch):
        vc = pkg.VorbisCommentBlock()
        vc.set("X", "y" * 100)
        ch.blocks.insert(1, vc)

    def past_padding(pkg, ch):
        ch.blocks.insert(1, pkg.ApplicationBlock(b"big!", b"q" * 5000))

    def sort_padding(pkg, ch):
        ch.blocks.insert(1, pkg.PaddingBlock(100))
        ch.sort_padding()

    def drop_padding(pkg, ch):
        ch.blocks = [b for b in ch.blocks if b.TYPE != 1]
    return {f.__name__: f for f in (unchanged, insert_tags, fits_padding,
                                    past_padding, sort_padding,
                                    drop_padding)}


CHAIN_EDITS = _chain_edits()


@pytest.mark.parametrize("edit", list(CHAIN_EDITS))
def test_chain_edit_matches(edit):
    data = _stream()
    outs = []
    for pkg in (jmd, md):
        ch = pkg.Chain.read(data)
        CHAIN_EDITS[edit](pkg, ch)
        outs.append(ch.write())
    assert outs[0] == outs[1]
    if edit == "unchanged":
        assert outs[1] == data
    if edit == "fits_padding":
        assert len(outs[1]) == len(data)
    _decodes(outs[1])
    assert md.Chain.read(outs[1]).streaminfo.total_samples == 8192


@pytest.mark.parametrize("edit", ["fits_padding", "past_padding"])
def test_chain_write_file_matches(tmp_path, edit):
    """Lazy file mode: an edit that fits the padding patches the file in
    place (same inode); one that does not shifts the tail through a temp
    file."""
    ref_p, port_p = _pair(tmp_path, _stream(tags=["T=a"]))
    inodes = []
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        ino = p.stat().st_ino
        ch = pkg.Chain.read_file(str(p))
        assert ch._frames is None
        CHAIN_EDITS[edit](pkg, ch)
        ch.write_file(str(p))
        inodes.append(p.stat().st_ino == ino)
    assert ref_p.read_bytes() == port_p.read_bytes()
    assert inodes == [edit == "fits_padding"] * 2
    _decodes(port_p.read_bytes())


def test_one_shot_getters_match(tmp_path):
    cs = _blocks(md)["cuesheet"]
    pic = _blocks(md)["picture"]
    data = encode_file_to_flac(
        PCM, EncoderConfig.from_preset(2), device="cpu",
        extra_metadata=[(b.TYPE, b.to_bytes()) for b in (
            md.VorbisCommentBlock(comments=["A=b"]), cs, pic)])
    p = tmp_path / "x.flac"
    p.write_bytes(data)
    for name in ("get_streaminfo", "get_tags", "get_cuesheet",
                 "get_picture"):
        got = getattr(md, name)(str(p))
        want = getattr(jmd, name)(str(p))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert md.get_tags(str(p)).get("A") == ["b"]


def test_chain_rejects_what_flac_tpu_rejects():
    data = _stream()
    for bad in (b"RIFF" + data[4:], data[:30], data[:4] + bytes(
            [0x06, 0, 0, 4, 0xFF])):
        with pytest.raises(md.MetadataError):
            md.Chain.read(bad)
        with pytest.raises(jmd.MetadataError):
            jmd.Chain.read(bad)


# ---------------------------------------------------------------------------
# SimpleIterator (level 1): the cases of tests/test_metadata.py
# ---------------------------------------------------------------------------

def _to_second(it):
    assert it.next()
    return it


def _op_same_size(pkg, it):
    _to_second(it)
    vc = it.get_block()
    vc.set("TITLE", "bbbb")
    it.set_block(vc)


def _op_grow_into_padding(pkg, it):
    _to_second(it)
    vc = it.get_block()
    vc.set("COMMENT", "y" * 300)
    it.set_block(vc)


def _op_shrink(pkg, it):
    _to_second(it)
    vc = it.get_block()
    vc.remove("TITLE")
    it.set_block(vc)


def _op_grow_beyond_padding(pkg, it):
    _to_second(it)
    vc = it.get_block()
    vc.set("BIG", "q" * 20000)
    it.set_block(vc)
    assert it.get_block_type() == fmt.METADATA_TYPE_VORBIS_COMMENT


def _op_delete_merges_padding(pkg, it):
    _to_second(it)
    it.delete_block()
    assert it.get_block_type() == fmt.METADATA_TYPE_STREAMINFO


def _op_delete_without_padding(pkg, it):
    _to_second(it)
    it.delete_block(use_padding=False)


def _op_insert_carves_padding(pkg, it):
    while not it.is_last():
        it.next()
    it.prev()
    it.insert_block_after(pkg.ApplicationBlock(b"xmpl", b"hello"))
    assert it.get_block_type() == fmt.METADATA_TYPE_APPLICATION


def _op_insert_exact_padding(pkg, it):
    while not it.is_last():
        it.next()
    length = it.get_block_length()
    it.prev()
    it.insert_block_after(pkg.ApplicationBlock(b"xmpl", b"h" * (length - 4)))


def _op_insert_no_padding(pkg, it):
    it.insert_block_after(pkg.ApplicationBlock(b"xmpl", b"hello"),
                          use_padding=False)


def _op_shrink_streaminfo_neighbour(pkg, it):
    _to_second(it)
    vc = it.get_block()
    vc.comments = []
    it.set_block(vc, use_padding=False)


ITERATOR_OPS = {f.__name__[4:]: f for f in (
    _op_same_size, _op_grow_into_padding, _op_shrink,
    _op_grow_beyond_padding, _op_delete_merges_padding,
    _op_delete_without_padding, _op_insert_carves_padding,
    _op_insert_exact_padding, _op_insert_no_padding,
    _op_shrink_streaminfo_neighbour)}


@pytest.mark.parametrize("op", list(ITERATOR_OPS))
def test_simple_iterator_edit_matches(tmp_path, op):
    """The same edit through each package's SimpleIterator leaves the same
    file bytes, the frames untouched, and the file still decodes."""
    ref_p, port_p = _pair(tmp_path, _stream(tags=["TITLE=aaaa"]))
    frames0 = port_p.read_bytes()[md.Chain.read(port_p.read_bytes())
                                  ._meta_bytes + 4:]
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p)) as it:
            ITERATOR_OPS[op](pkg, it)
    data = port_p.read_bytes()
    assert ref_p.read_bytes() == data
    assert data[md.Chain.read(data)._meta_bytes + 4:] == frames0
    _decodes(data)


def test_simple_iterator_navigation_matches(tmp_path):
    ref_p, port_p = _pair(tmp_path, _stream(tags=["A=1"],
                                            apps=[(b"xmpl", b"x")]))
    walks = []
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p), read_only=True) as it:
            assert not it.is_writable()
            seen = []
            while True:
                seen.append((it.get_block_type(), it.get_block_offset(),
                             it.get_block_length(), it.is_last(),
                             it.get_block().to_bytes()))
                if not it.next():
                    break
            while it.prev():
                pass
            it.next()
            it.next()
            seen.append(it.get_application_id())
            walks.append(seen)
    assert walks[0] == walks[1]
    assert walks[1][-1] == b"xmpl"


def test_simple_iterator_guards_match(tmp_path):
    ref_p, port_p = _pair(tmp_path, _stream())
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p)) as it:
            with pytest.raises(pkg.MetadataError, match="STREAMINFO"):
                it.delete_block()
            with pytest.raises(pkg.MetadataError, match="STREAMINFO"):
                it.set_block(pkg.PaddingBlock(8))
            with pytest.raises(pkg.MetadataError, match="STREAMINFO"):
                it.insert_block_after(pkg.StreamInfoBlock())
            with pytest.raises(pkg.MetadataError, match="APPLICATION"):
                it.get_application_id()
        with pkg.SimpleIterator(str(p), read_only=True) as it:
            with pytest.raises(pkg.MetadataError, match="read-only"):
                it.delete_block()
    assert ref_p.read_bytes() == port_p.read_bytes()


# ---------------------------------------------------------------------------
# the four fixes: where the port differs from flac_tpu on purpose
# ---------------------------------------------------------------------------

def test_fix_insert_after_the_last_block(tmp_path):
    """No PADDING at the end: flac_tpu's insert_block_after on the last
    block raises IndexError; the port appends the block, and the old last
    block is last no more."""
    data = _stream(tags=["A=1"], padding=0)
    ref_p, port_p = _pair(tmp_path, data)
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p)) as it:
            while it.next():
                pass
            assert it.get_block_type() == fmt.METADATA_TYPE_VORBIS_COMMENT
            app = pkg.ApplicationBlock(b"xmpl", b"appended")
            if pkg is jmd:
                with pytest.raises(IndexError):
                    it.insert_block_after(app)
            else:
                it.insert_block_after(app)
                assert it.get_block_type() == fmt.METADATA_TYPE_APPLICATION
                assert it.is_last()
    assert ref_p.read_bytes() == data
    got = port_p.read_bytes()
    blocks = md.parse_metadata_blocks(got)
    assert [t for t, _ in blocks] == [fmt.METADATA_TYPE_STREAMINFO,
                                      fmt.METADATA_TYPE_VORBIS_COMMENT,
                                      fmt.METADATA_TYPE_APPLICATION]
    with md.SimpleIterator(str(port_p), read_only=True) as it:
        flags = [it.is_last()]
        while it.next():
            flags.append(it.is_last())
    assert flags == [False, False, True]
    assert len(got) == len(data) + 4 + 12
    _decodes(got)


@pytest.mark.parametrize("how", ["iterator", "chain"])
def test_fix_rewrite_keeps_the_file_mode(tmp_path, how):
    """A metadata edit that shifts the audio rewrites the file through a
    temp file: flac_tpu's result has mode 0600, the port's keeps the
    file's 0640.  The bytes are the same."""
    ref_p, port_p = _pair(tmp_path, _stream(tags=["T=a"]), mode=0o640)
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        if how == "iterator":
            with pkg.SimpleIterator(str(p)) as it:
                _op_grow_beyond_padding(pkg, it)
        else:
            ch = pkg.Chain.read_file(str(p))
            CHAIN_EDITS["past_padding"](pkg, ch)
            ch.write_file(str(p))
    assert ref_p.read_bytes() == port_p.read_bytes()
    assert oct(ref_p.stat().st_mode & 0o777) == oct(0o600)
    assert oct(port_p.stat().st_mode & 0o777) == oct(0o640)


def test_fix_delete_zeroes_the_body(tmp_path):
    """Deleting a block that no PADDING follows turns it into PADDING:
    flac_tpu only retypes the header, so the deleted tag stays readable in
    the file; the port zeroes the body as well."""
    data = _stream(tags=["SECRET=hunter2"], padding=0,
                   apps=[(b"xmpl", b"after")])
    ref_p, port_p = _pair(tmp_path, data)
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p)) as it:
            _to_second(it)
            length = it.get_block_length()
            it.delete_block()
            assert it.get_block_type() == fmt.METADATA_TYPE_STREAMINFO
    ref, port = ref_p.read_bytes(), port_p.read_bytes()
    assert b"SECRET=hunter2" in ref and b"SECRET=hunter2" not in port
    assert len(ref) == len(port) == len(data)
    blocks = md.parse_metadata_blocks(port)
    assert blocks == [(t, b"\x00" * length if t == fmt.METADATA_TYPE_PADDING
                       else body) for t, body in
                      jmd.parse_metadata_blocks(ref)]
    assert md.get_tags(str(port_p)) is None
    _decodes(port)


def test_fix_rewrite_region_takes_no_cursor_offset(tmp_path):
    """flac_tpu's _rewrite_region takes a keep_offset that nothing passes
    or reads; the port's does not.  The cursor after a tail shift is the
    same in both (callers re-seek by index)."""
    ref_sig = inspect.signature(jmd.SimpleIterator._rewrite_region)
    port_sig = inspect.signature(md.SimpleIterator._rewrite_region)
    assert "keep_offset" in ref_sig.parameters
    assert list(port_sig.parameters) == ["self", "start", "end", "new"]
    ref_p, port_p = _pair(tmp_path, _stream(tags=["T=a"]))
    cursors = []
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p)) as it:
            _op_grow_beyond_padding(pkg, it)
            cursors.append((it.get_block_offset(), it.get_block_type()))
    assert cursors[0] == cursors[1]
    assert ref_p.read_bytes() == port_p.read_bytes()


def test_preserve_file_stats_matches(tmp_path):
    ref_p, port_p = _pair(tmp_path, _stream(tags=["T=a"]))
    for p in (ref_p, port_p):
        os.utime(p, ns=(1_000_000_000, 2_000_000_000))
    for pkg, p in ((jmd, ref_p), (md, port_p)):
        with pkg.SimpleIterator(str(p), preserve_file_stats=True) as it:
            _op_grow_beyond_padding(pkg, it)
    assert ref_p.stat().st_mtime_ns == port_p.stat().st_mtime_ns == \
        2_000_000_000
    assert ref_p.read_bytes() == port_p.read_bytes()


# ---------------------------------------------------------------------------
# cuesheet: the cases of tests/test_cuesheet.py
# ---------------------------------------------------------------------------

CUE = """\
CATALOG 1234567890123
FILE "dummy.wav" WAVE
  TRACK 01 AUDIO
    ISRC USRC17607839
    INDEX 01 00:00:00
  TRACK 02 AUDIO
    FLAGS PRE
    INDEX 00 00:01:70
    INDEX 01 00:02:00
"""

NON_CDDA = """\
TRACK 01 AUDIO
  INDEX 01 0
TRACK 02 AUDIO
  INDEX 01 96000
"""


@pytest.mark.parametrize("text, rate, is_cd, lead_out", [
    (CUE, 44100, True, 44100 * 4),
    (NON_CDDA, 96000, False, 96000 * 3),
    ("TRACK 1 AUDIO\n  INDEX 1 0:01.5\n", 96000, False, 96000 * 3),
    ('REM a remark\nPERFORMER "x"\nTRACK 01 AUDIO\n  TITLE "t"\n'
     "  INDEX 01 00:00:00\n  INDEX 02 00:00:30\n", 44100, True, 44100 * 2),
])
def test_cuesheet_parse_and_emit_match(text, rate, is_cd, lead_out):
    port = cue.parse_cuesheet(text, rate, is_cd, lead_out)
    ref = jcue.parse_cuesheet(text, rate, is_cd, lead_out)
    body = port.to_bytes()
    assert body == ref.to_bytes()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    emitted = cue.emit_cuesheet(port, '"x.flac" FLAC')
    assert emitted == jcue.emit_cuesheet(ref, '"x.flac" FLAC')
    again = cue.parse_cuesheet(emitted, rate, is_cd, lead_out)
    assert again.to_bytes() == body
    assert md.CueSheetBlock.parse(body).to_bytes() == body


def test_cuesheet_cdda_fields():
    cs = cue.parse_cuesheet(CUE, 44100, True, 44100 * 4)
    t1, t2, lo = cs.tracks
    assert cs.is_cd and cs.lead_in == 88200
    assert t1.isrc == b"USRC17607839" and t2.pre_emphasis
    assert t2.offset == 44100 + 70 * 588
    assert [(i.number, i.offset) for i in t2.indices] == [
        (0, 0), (1, 2 * 44100 - t2.offset)]
    assert lo.number == 170 and lo.offset == 44100 * 4
    text = cue.emit_cuesheet(cs, '"x.flac" FLAC')
    assert "REM FLAC__lead-in 88200" in text
    assert "REM FLAC__lead-out 170 176400" in text


@pytest.mark.parametrize("text, rate, msg", [
    ("", 44100, "at least one TRACK"),
    ("TRACK 01 AUDIO\n", 44100, "at least one INDEX"),
    ("INDEX 01 00:00:00\n", 44100, "INDEX before any TRACK"),
    ("TRACK 01 AUDIO\n  INDEX 02 00:00:00\n", 44100, "must be 0 or 1"),
    ("TRACK 01 AUDIO\n  INDEX 01 00:00:00\n  INDEX 03 00:01:00\n", 44100,
     "sequential"),
    ("CATALOG 123\nTRACK 01 AUDIO\n  INDEX 01 00:00:00\n", 44100,
     "13 decimal digits"),
    ("TRACK 01 AUDIO\n  INDEX 01 00:00:01\n", 44100, "offset of 00:00:00"),
    ("TRACK 00 AUDIO\n", 44100, "greater than 0"),
    ("TRACK 01 AUDIO\n  ISRC bogus\n  INDEX 01 00:00:00\n", 44100,
     "invalid ISRC"),
    ("CATALOG 1234567890123\nCATALOG 1234567890123\n", 44100,
     "multiple CATALOG"),
    ("TRACK 1 AUDIO\n  INDEX 1 00:00:01\n", 44101, "multiple of 75"),
])
def test_cuesheet_errors_match(text, rate, msg):
    """Each package raises CueSheetParseError with the same message and
    line number."""
    with pytest.raises(cue.CueSheetParseError, match=msg) as port:
        cue.parse_cuesheet(text, rate, rate == 44100, rate)
    with pytest.raises(jcue.CueSheetParseError) as ref:
        jcue.parse_cuesheet(text, rate, rate == 44100, rate)
    assert str(port.value) == str(ref.value)
    assert port.value.line_number == ref.value.line_number
