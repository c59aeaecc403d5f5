"""flac_tpu_torch.container against flac_tpu.container, on the CPU.

Every writer gets the same PCM in both packages and must give the same
bytes; every reader gets the same bytes and must give the same sample
rate, channels, bits per sample, samples and carried metadata.  The
hostile layouts of tests/test_container_hostile.py go through both
readers, which must agree on the result or raise the same error class
(by name) with the same message.  A FLAC and an Ogg FLAC input decode
through the port's decode_stream_auto on the CPU; flac_tpu decodes them
with its "auto" engine, which takes the host engine at this size, so
nothing compiles.
"""

import io
import struct

import numpy as np
import pytest
import torch

from flac_tpu import container as jc
from flac_tpu import metadata as jmd
from flac_tpu_torch import EncoderConfig, container, ogg
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import encode_file_to_flac

from conftest import make_test_signal
from test_container_hostile import _chunk, _data_bytes, _fmt16, _pcm16, _wav

torch.set_num_threads(1)

SHAPES = [(1, 8), (2, 12), (2, 16), (6, 20), (2, 24), (3, 32)]


def _pcm(channels, bps, n=301, seed=0):
    rng = np.random.default_rng(seed + bps)
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1))
    pcm = rng.integers(lo, hi, (channels, n), dtype=np.int64)
    pcm[:, 0], pcm[:, 1] = lo, hi - 1        # full scale both ways
    return pcm.astype(np.int32)


def _same_info(a, b):
    assert (a.sample_rate, a.channels, a.bits_per_sample) == \
        (b.sample_rate, b.channels, b.bits_per_sample)
    assert a.samples.dtype == b.samples.dtype
    np.testing.assert_array_equal(a.samples, b.samples)
    assert a.metadata == b.metadata


def _outcome(fn, *args, **kw):
    """fn's result, or its error as (class name, message)."""
    try:
        return fn(*args, **kw), None
    except Exception as e:          # compared across the two packages
        return None, (type(e).__name__, str(e))


# the port writes and reads the Wave64 format's WAVE, fmt and data GUIDs,
# flac_tpu GUIDs that end 8CD10080 5F9CF04F (a difference kept on
# purpose): the port's Wave64 file with flac_tpu's GUIDs in their places
# is flac_tpu's file
_W64_GUIDS = {container._W64_WAVE: jc._W64_WAVE,
              container._W64_FMT: jc._W64_FMT,
              container._W64_DATA: jc._W64_DATA}


def as_reference_w64(blob: bytes) -> bytes:
    """`blob` with each of the port's Wave64 GUIDs (the WAVE GUID and every
    chunk's) replaced by flac_tpu's; other bytes unchanged."""
    out = bytearray(blob)
    wave = bytes(out[24:40])
    if wave in _W64_GUIDS:
        out[24:40] = _W64_GUIDS[wave]
    pos = 40
    while pos + 24 <= len(out):
        guid = bytes(out[pos:pos + 16])
        if guid in _W64_GUIDS:
            out[pos:pos + 16] = _W64_GUIDS[guid]
        size = struct.unpack("<Q", out[pos + 16:pos + 24])[0]
        if size < 24:
            break
        pos += (size + 7) & ~7
    return bytes(out)


def _both_read(name, blob, ref_blob=None, **kw):
    """The port reads `blob`, flac_tpu `ref_blob` (default: the same
    bytes); both must give the same result or the same error."""
    got, err = _outcome(getattr(container, name), blob, **kw)
    want, want_err = _outcome(getattr(jc, name),
                              blob if ref_blob is None else ref_blob, **kw)
    assert err == want_err
    if err is None:
        _same_info(got, want)
    return got, err


WRITERS = [
    ("wav", lambda m, p, bps: m.write_wav(p, 48000, bps), "read_wav"),
    ("rf64", lambda m, p, bps: m.write_rf64(p, 48000, bps), "read_wav"),
    ("w64", lambda m, p, bps: m.write_w64(p, 48000, bps), "read_w64"),
    ("aiff", lambda m, p, bps: m.write_aiff(p, 48000, bps), "read_aiff"),
    ("aiff-c-none", lambda m, p, bps: m.write_aiff(
        p, 48000, bps, compression=b"NONE"), "read_aiff"),
    ("aiff-c-sowt", lambda m, p, bps: m.write_aiff(
        p, 48000, bps, compression=b"sowt"), "read_aiff"),
]


@pytest.mark.parametrize("kind, write, read", WRITERS,
                         ids=[w[0] for w in WRITERS])
def test_writers_and_readers_match(kind, write, read):
    for channels, bps in SHAPES:
        pcm = _pcm(channels, bps)
        blob = write(container, pcm, bps)
        ref = as_reference_w64(blob) if kind == "w64" else blob
        assert ref == write(jc, pcm, bps), (kind, channels, bps)
        info, err = _both_read(read, blob, ref)
        assert err is None
        if info.bits_per_sample == bps:  # read_w64 takes no EXTENSIBLE bps
            np.testing.assert_array_equal(info.samples, pcm)
        _same_info(container.sniff_and_read(blob, device="cpu"),
                   jc.sniff_and_read(ref))
        if kind == "wav":
            info = container.write_wav(container.AudioInfo(
                48000, channels, bps, pcm))
            assert info == jc.write_wav(jc.AudioInfo(48000, channels, bps,
                                                     pcm))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("big_endian", [False, True])
def test_raw_matches(signed, big_endian):
    for channels, bps in SHAPES:
        pcm = _pcm(channels, bps, seed=1)
        kw = dict(big_endian=big_endian, signed=signed)
        blob = container.write_raw(pcm, bps, **kw)
        assert blob == jc.write_raw(pcm, bps, **kw)
        rkw = dict(sample_rate=8000, channels=channels, bits_per_sample=bps,
                   **kw)
        _same_info(container.read_raw(blob, **rkw), jc.read_raw(blob, **rkw))


def _hostile_blobs():
    """The layouts of tests/test_container_hostile.py, built once."""
    pcm = _pcm16(256)
    base = _fmt16()
    ext = (struct.pack("<HHI", 22, 16, 0x3)
           + b"\x01\x00\x00\x00\x00\x00\x10\x00"
           + b"\x80\x00\x00\xaa\x00\x38\x9b\x71")
    body_ext = struct.pack("<HHIIHH", 0xFFFE, 2, 44100, 44100 * 4, 4,
                           16) + ext
    data = _chunk(b"data", _data_bytes(pcm))
    w64 = bytearray(container.write_w64(pcm, 44100, 16))
    w64[40:40] = bytes(range(16)) + struct.pack("<Q", 24 + 8) + b"\xee" * 8
    w64[16:24] = struct.pack("<Q", len(w64))
    aiff = container.write_aiff(pcm, 44100, 16)
    anno = aiff[8:12] + b"ANNO" + struct.pack(">I", 4) + b"test" + aiff[12:]
    return {
        "wacky chunks": ("read_wav", _wav([
            _chunk(b"junk", b"\xa5" * 33),
            _chunk(b"LIST", b"INFOIART" + b"\x07\x00\x00\x00nobody\x00"),
            _chunk(b"fmt ", base), _chunk(b"pad ", b"\x00" * 100), data,
            _chunk(b"tail", b"\x42" * 10)]), {}),
        "fmt cbSize 0": ("read_wav", _wav([
            _chunk(b"fmt ", base + b"\x00\x00"), data]), {}),
        "fmt extensible": ("read_wav", _wav([
            _chunk(b"fmt ", body_ext), data]), {}),
        "truncated tail": ("read_wav", _wav([
            _chunk(b"fmt ", base), data]) + b"tr", {}),
        "data size 0": ("read_wav", _wav([
            _chunk(b"fmt ", base),
            b"data" + struct.pack("<I", 0) + _data_bytes(pcm)]),
            {"ignore_chunk_sizes": True}),
        "missing fmt": ("read_wav", _wav([_chunk(b"data", b"\x00" * 64)]),
                        {}),
        "empty": ("read_wav", b"", {}),
        "RIFF only": ("read_wav", b"RIFF", {}),
        "no chunks": ("read_wav", b"RIFF\xff\xff\xff\xffWAVE", {}),
        "fmt past the end": ("read_wav",
                             b"RIFF\x10\x00\x00\x00WAVEfmt \xff\xff\xff\xff",
                             {}),
        "w64 unknown guid": ("read_w64", bytes(w64), {}),
        "aiff anno first": ("read_aiff", b"FORM" + struct.pack(
            ">I", len(anno)) + anno, {}),
        "aiff-c alaw": ("read_aiff", container.write_aiff(
            pcm, 44100, 16, compression=b"NONE").replace(b"NONE", b"alaw"),
            {}),
        "not audio": ("sniff_and_read", b"\x00" * 64, {}),
        "not a w64": ("read_w64", b"\x00" * 64, {}),
        "not an aiff": ("read_aiff", b"RIFF" + b"\x00" * 60, {}),
    }


@pytest.mark.parametrize("case", sorted(_hostile_blobs()))
def test_hostile_inputs_match(case):
    reader, blob, kw = _hostile_blobs()[case]
    _both_read(reader, blob,
               as_reference_w64(blob) if reader == "read_w64" else blob,
               **kw)


def _flac_input():
    pcm = make_test_signal(4000, seed=4)
    vc = md.VorbisCommentBlock()
    vc.comments.append("TITLE=re-encode")
    return encode_file_to_flac(pcm, EncoderConfig.from_preset(
        1, blocksize=1024), extra_metadata=[(vc.TYPE, vc.to_bytes())],
        device="cpu"), pcm


@pytest.mark.parametrize("wrap", ["flac", "ogg"])
def test_flac_and_ogg_input_match(wrap):
    stream, pcm = _flac_input()
    if wrap == "ogg":
        out = io.BytesIO()
        ogg.wrap_flac_stream(stream, out)
        stream = out.getvalue()
    info = container.sniff_and_read(stream, device="cpu")
    _same_info(info, jc.sniff_and_read(stream))
    np.testing.assert_array_equal(info.samples, pcm)
    if wrap == "flac":
        vc = jmd.VorbisCommentBlock.parse(dict(info.metadata)[4])
        assert vc.comments == ["TITLE=re-encode"]
    else:
        assert info.metadata == []
