"""The encoder's library API in flac_tpu_torch against flac_tpu's, on the CPU.

This covers the `with` form and close(), progress_callback, the stream
header's block order and is_last flags, extra metadata, the seek table
(template, resolution, back-patch) and verify=True.  The cases of
tests/test_verify_mode.py run here through the port.  There the flipped
bit is injected after encode_batch returns, where the reference's tests
inject it after the jit boundary.

Only one flac_tpu stream encode runs (the whole-stream byte identity at
-1).  The header and seek-table cases build flac_tpu encoders that never
encode, or call its seek-table resolution directly, so they compile
nothing.
"""

import io

import numpy as np
import pytest
import torch

import flac_tpu
from flac_tpu import format as jfmt
from flac_tpu import metadata as jmd
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu.encoder import StreamEncoder as RefEncoder
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac

from conftest import make_test_signal

torch.set_num_threads(1)

N = 1024
BATCH = 8
N_SAMPLES = N * 20 + 300        # batches of 8, 8, 4, then the short block


def _extra(pkg):
    """A VORBIS_COMMENT and a PICTURE as raw (type, body) blocks."""
    vc = pkg.VorbisCommentBlock()
    vc.set("TITLE", "parity")
    vc.set("ARTIST", "flac_tpu_torch")
    pic = pkg.PictureBlock(picture_type=3, mime_type="image/png",
                           description="cover", width=2, height=2, depth=24,
                           data=b"\x89PNG fake picture")
    return [(vc.TYPE, vc.to_bytes()), (pic.TYPE, pic.to_bytes())]


@pytest.fixture(scope="module")
def streams():
    """The same -1 encode (blocksize 1024, a seek table every 0.1 s, tags,
    a picture, 4096 bytes of padding) through both packages' `with` form,
    with the progress callbacks each saw."""
    pcm = make_test_signal(N_SAMPLES, seed=11)
    out = {"pcm": pcm}
    for name, pkg, enc_cls, kw in (
            ("ref", jmd, RefEncoder, {}),
            ("port", md, StreamEncoder, {"device": "cpu"})):
        cfg = (flac_tpu.EncoderConfig if name == "ref" else
               EncoderConfig).from_preset(1, blocksize=N)
        calls = []
        buf = io.BytesIO()
        with enc_cls(buf, cfg, batch_frames=BATCH,
                     extra_metadata=_extra(pkg),
                     seektable=pkg.SeekTableBlock.template_spaced(
                         N_SAMPLES, 44100, 0.1),
                     progress_callback=lambda *a: calls.append(a),
                     **kw) as enc:
            enc.process(pcm)
            enc.finish()
        out[name] = buf.getvalue()
        out[name + "_calls"] = calls
        out[name + "_first_frame"] = enc._first_frame_offset
    return out


def test_stream_with_metadata_is_byte_identical(streams):
    """Seek table, VORBIS_COMMENT, PICTURE and padding together: the port
    writes flac_tpu's bytes, and they decode back with the MD5."""
    assert streams["port"] == streams["ref"]
    assert streams["port_first_frame"] == streams["ref_first_frame"]
    st = ref_decode(streams["port"], engine="host")
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, streams["pcm"])
    chain = jmd.Chain.read(streams["port"])
    assert [b.TYPE for b in chain.blocks] == [
        jfmt.METADATA_TYPE_STREAMINFO, jfmt.METADATA_TYPE_SEEKTABLE,
        jfmt.METADATA_TYPE_VORBIS_COMMENT, jfmt.METADATA_TYPE_PICTURE,
        jfmt.METADATA_TYPE_PADDING]
    assert chain.blocks[-1].length == 4096


def test_written_seek_table_is_legal_and_on_frames(streams):
    data = streams["port"]
    table = md.Chain.read(data).get(md.SeekTableBlock.TYPE)
    assert table.is_legal()
    real = [p for p in table.points if not p.is_placeholder]
    assert len(real) >= 5
    first = streams["port_first_frame"]
    for p in real:
        assert p.sample_number % N == 0 and p.frame_samples in (N, 300)
        assert data[first + p.stream_offset] == 0xFF


def test_progress_callback_once_per_written_batch(streams):
    """Once a written super-chunk or batch, as flac_tpu calls it: frames
    done, the blocksize and the frame bytes written so far.  The two full
    batches go out as one super-chunk, then the batch of 4 and the
    300-sample tail."""
    calls = streams["port_calls"]
    assert calls == streams["ref_calls"]
    assert [c[0] for c in calls] == [16, 20, 21]
    assert all(c[1] == N for c in calls)
    frame_bytes = len(streams["port"]) - streams["port_first_frame"]
    assert calls[-1] == (21, N, frame_bytes)
    assert [c[2] for c in calls] == sorted({c[2] for c in calls})


def test_with_form_closes_and_close_is_idempotent():
    pcm = make_test_signal(3000, seed=2)
    buf = io.BytesIO()
    with StreamEncoder(buf, EncoderConfig.from_preset(0, blocksize=N),
                       device="cpu") as enc:
        enc.process(pcm)
        enc.finish()
    enc.close()
    enc.close()
    with pytest.raises(RuntimeError, match="closed"):
        enc.process(pcm)
    with pytest.raises(RuntimeError, match="closed"):
        enc.finish()
    st = ref_decode(buf.getvalue(), engine="host")
    np.testing.assert_array_equal(st.samples, pcm)


def test_with_form_closes_on_error():
    with pytest.raises(ValueError, match="boom"):
        with StreamEncoder(io.BytesIO(), EncoderConfig.from_preset(
                0, blocksize=N), device="cpu") as enc:
            raise ValueError("boom")
    with pytest.raises(RuntimeError, match="closed"):
        enc.finish()


def test_encode_file_to_flac_uses_the_with_form(monkeypatch):
    closed = []
    real = StreamEncoder.close
    monkeypatch.setattr(StreamEncoder, "close",
                        lambda self: closed.append(self) or real(self))
    pcm = make_test_signal(2000, seed=3)
    encode_file_to_flac(pcm, EncoderConfig.from_preset(0, blocksize=N),
                        device="cpu")
    assert len(closed) == 1


@pytest.mark.parametrize("kw", ["pipeline_depth", "super_batches"])
def test_pipeline_options_match_flac_tpu(kw):
    """Both packages take pipeline_depth and super_batches, with the same
    defaults and the same clamps (batches and super-chunks in flight,
    batches a super-chunk).  flac_tpu's encoders never encode, so nothing
    compiles."""
    for value in (None, -1, 0, 1, 3, 8):
        seen = []
        for enc_cls, cfg_cls, extra in (
                (RefEncoder, flac_tpu.EncoderConfig, {}),
                (StreamEncoder, EncoderConfig, {"device": "cpu"})):
            opts = {} if value is None else {kw: value}
            enc = enc_cls(io.BytesIO(), cfg_cls.from_preset(0), **opts,
                          **extra)
            enc.close()
            seen.append((enc._pipeline_depth, enc._super_batches,
                         enc._super_depth))
        assert seen[0] == seen[1]


@pytest.mark.parametrize("padding", [0, 512])
@pytest.mark.parametrize("seektable", [False, True])
@pytest.mark.parametrize("n_extra", [0, 1, 2])
def test_stream_header_matches(padding, seektable, n_extra):
    """The header each package writes before any audio: STREAMINFO, then
    SEEKTABLE, the extra blocks and PADDING, with the same is_last flags
    and first frame offset.  flac_tpu's encoder is built and closed
    without encoding, so nothing compiles."""
    outs, offsets = [], []
    for pkg, enc_cls, cfg_cls, kw in (
            (jmd, RefEncoder, flac_tpu.EncoderConfig, {}),
            (md, StreamEncoder, EncoderConfig, {"device": "cpu"})):
        buf = io.BytesIO()
        table = (pkg.SeekTableBlock.template_count(5, 44100 * 3)
                 if seektable else None)
        enc = enc_cls(buf, cfg_cls.from_preset(5), padding=padding,
                      extra_metadata=_extra(pkg)[:n_extra], seektable=table,
                      **kw)
        enc.close()
        outs.append(buf.getvalue())
        offsets.append(enc._first_frame_offset)
    assert outs[0] == outs[1]
    assert offsets[0] == offsets[1] == len(outs[1])
    blocks = md.parse_metadata_blocks(outs[1])
    assert len(blocks) == 1 + seektable + n_extra + (padding > 0)


def _templates(pkg, total):
    P = pkg.SeekPoint
    return {
        "spaced": pkg.SeekTableBlock.template_spaced(total, 44100, 0.05),
        "count": pkg.SeekTableBlock.template_count(7, total),
        "count, unknown length": pkg.SeekTableBlock.template_count(3),
        "past the end and duplicates": pkg.SeekTableBlock(points=[
            P(0, 0, 0), P(10, 0, 0), P(N + 5, 0, 0), P(total + 10 ** 6, 0, 0),
            P(jfmt.SEEKPOINT_PLACEHOLDER, 0, 0)]),
    }


@pytest.mark.parametrize("name", ["spaced", "count",
                                  "count, unknown length",
                                  "past the end and duplicates"])
@pytest.mark.parametrize("n_frames", [0, 1, 9])
def test_seek_table_resolution_matches(name, n_frames):
    """Both packages resolve a template against the same frame index (first
    sample, offset, blocksize) to the same points: each target on the
    frame that holds it, duplicates merged, placeholders padding the
    table to its reserved size."""
    total = N * n_frames
    index = [(i * N, 100 + 3000 * i, N) for i in range(n_frames)]
    tables = []
    for pkg, enc_cls, cfg_cls, kw in (
            (jmd, RefEncoder, flac_tpu.EncoderConfig, {}),
            (md, StreamEncoder, EncoderConfig, {"device": "cpu"})):
        table = _templates(pkg, max(total, 1))[name]
        enc = enc_cls(io.BytesIO(), cfg_cls.from_preset(5, blocksize=N),
                      seektable=table, **kw)
        enc._frame_index = list(index)
        enc._info.total_samples = total
        enc._resolve_seektable()
        enc.close()
        tables.append(table.to_bytes())
    assert tables[0] == tables[1]
    assert md.SeekTableBlock.parse(tables[1]).is_legal()


# ---------------------------------------------------------------------------
# verify=True: the cases of tests/test_verify_mode.py
# ---------------------------------------------------------------------------

def _encode(pcm, level, verify, **kw):
    buf = io.BytesIO()
    with StreamEncoder(buf, EncoderConfig.from_preset(level, blocksize=N),
                       batch_frames=4, device="cpu", verify=verify,
                       **kw) as enc:
        enc.process(pcm)
        enc.finish()
    return buf


@pytest.mark.parametrize("level", [0, 3])
def test_verify_clean_encode_passes(level):
    """verify=True leaves the bytes as they are, and the stream decodes
    back through flac_tpu."""
    pcm = make_test_signal(N * 6 + 100, seed=level)
    verified = _encode(pcm, level, True).getvalue()
    assert verified == _encode(pcm, level, False).getvalue()
    st = ref_decode(verified, engine="host")
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, pcm)


def _corrupting(monkeypatch, row: int, word: int, bit: int):
    """Wrap encode_batch so that one bit of its packed words flips after it
    returns, the way a packer bug would corrupt them."""
    real = encoder_mod.encode_batch

    def corrupted(*a, **k):
        pf = real(*a, **k)
        words = pf.words.clone()
        words[min(row, words.shape[0] - 1), word] ^= 1 << bit
        return pf._replace(words=words)
    monkeypatch.setattr(encoder_mod, "encode_batch", corrupted)


@pytest.mark.parametrize("level, row, word, bit, match", [
    (3, 0, 8, 7, "stream NOT written"),     # a payload bit
    (0, 1, 0, 16, "invalid header"),        # the blocking-strategy bit
])
def test_verify_catches_a_flipped_bit(monkeypatch, level, row, word, bit,
                                      match):
    """One bit flipped in the packed words after encode_batch returns:
    verify must raise before any frame byte reaches the output."""
    pcm = make_test_signal(N * 4, seed=5)
    _corrupting(monkeypatch, row, word, bit)
    out = io.BytesIO()
    enc = StreamEncoder(out, EncoderConfig.from_preset(level, blocksize=N),
                        batch_frames=4, device="cpu", verify=True)
    header = out.tell()
    with pytest.raises(RuntimeError, match="verify") as err:
        enc.process(pcm)
        enc.finish()
    assert match in str(err.value)
    assert len(out.getvalue()) == header == enc._first_frame_offset


def test_verify_reports_the_first_differing_sample(monkeypatch):
    """A decode that disagrees with the input names the frame, channel and
    sample in the reference's words."""
    real = encoder_mod.decode_frame_list

    def off_by_one(*a, **k):
        out = [s.copy() for s in real(*a, **k)]
        out[1][1, 5] += 1
        return out
    monkeypatch.setattr(encoder_mod, "decode_frame_list", off_by_one)
    pcm = make_test_signal(N * 4, seed=6)
    with pytest.raises(RuntimeError) as err:
        _encode(pcm, 0, True)
    assert str(err.value) == ("verify mismatch in audio data: frame 1, "
                              "channel 1, sample 5 (stream NOT written)")


def test_verify_uses_the_device_engine(monkeypatch):
    """verify decodes through decode_frame_list's default engine, "device"
    (K2 and K3 on the card), on the encoder's device."""
    seen = []
    real = encoder_mod.decode_frame_list

    def spy(*a, **k):
        seen.append((k.get("engine", "device"), k["device"]))
        return real(*a, **k)
    monkeypatch.setattr(encoder_mod, "decode_frame_list", spy)
    _encode(make_test_signal(N * 5, seed=7), 0, True)
    assert seen == [("device", torch.device("cpu"))] * 2
