"""flac_tpu_torch.ogg against flac_tpu.ogg, on the CPU.

These are the cases of tests/test_ogg.py: the page CRC, the page writer
and reader, the packetizer, wrapping and unwrapping, chained links, the
header count of 0, resync after garbage, ranged decode and the streaming
encode sink.  Both packages get the same bytes and must give the same
bytes and samples back.  The port decodes on the CPU through the "device"
engine (the plain versions of K2 and K3) and the host engine.  flac_tpu
decodes with its host engine, so nothing compiles.  The one flac_tpu
stream encode is the Ogg sink's, at -1 with blocksize 1024.
"""

import io

import numpy as np
import pytest
import torch

import flac_tpu
from flac_tpu import ogg as jogg
from flac_tpu.decoder import decode_stream_auto as ref_auto
from flac_tpu.encoder import StreamEncoder as RefEncoder
from flac_tpu_torch import EncoderConfig, ogg
from flac_tpu_torch.decoder import decode_stream_auto
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac

from conftest import make_test_signal

torch.set_num_threads(1)

N = 1024
CPU = {"device": "cpu"}


def _stream(seed=0, n=8192, level=3):
    pcm = make_test_signal(n, seed=seed)
    return encode_file_to_flac(pcm, EncoderConfig.from_preset(
        level, blocksize=N), device="cpu"), pcm


def _wrap(pkg, flac, **kw):
    out = io.BytesIO()
    pkg.wrap_flac_stream(flac, out, **kw)
    return out.getvalue()


def _packets(pkg, data):
    return [(s, p, pg["granulepos"]) for s, p, pg in pkg.pages_to_packets(
        pg for pg, _ in pkg.read_pages(data))]


def test_crc_and_page_bytes_match():
    rng = np.random.default_rng(1)
    for n in (0, 1, 255, 4096):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ogg.crc32_ogg(blob) == jogg.crc32_ogg(blob)
    segs = [b"hello", b"x" * 255, b""]
    page = ogg.OggPage(0x02, 12345, 7, 3, segs).to_bytes()
    assert page == jogg.OggPage(0x02, 12345, 7, 3, segs).to_bytes()
    crc = int.from_bytes(page[22:26], "little")
    assert ogg.crc32_ogg(page[:22] + b"\0\0\0\0" + page[26:]) == crc


def _write_packets(pkg):
    out = io.BytesIO()
    w = pkg.PageWriter(out, serial=7)
    big = bytes(range(256)) * 300      # 76800 B: spans several pages
    w.write_packet(b"first", 0, flush=True)
    w.write_packet(big, 111)
    w.write_packet(b"x" * 255, 222, eos=True)   # an exact lacing boundary
    return out.getvalue(), big


def test_page_writer_and_reader_match():
    data, big = _write_packets(ogg)
    assert data == _write_packets(jogg)[0]
    assert [p for _, p, _ in _packets(ogg, data)] == [b"first", big,
                                                      b"x" * 255]
    assert _packets(ogg, data) == _packets(jogg, data)
    pages = [(pg, end) for pg, end in ogg.read_pages(data)]
    assert pages == [(pg, end) for pg, end in jogg.read_pages(data)]


@pytest.mark.parametrize("path", ["device", "host"])
def test_wrap_and_decode_match(path):
    stream, pcm = _stream()
    data = _wrap(ogg, stream)
    assert data == _wrap(jogg, stream)
    assert ogg.is_ogg(data) and not ogg.is_ogg(stream)
    first = next(ogg.read_pages(data))[0]
    assert first["header_type"] & 0x02
    assert first["segments"][0][:5] == b"\x7fFLAC"
    last = [pg for pg, _ in ogg.read_pages(data)][-1]
    assert last["header_type"] & 0x04
    assert last["granulepos"] == pcm.shape[1]
    engine = "device" if path == "device" else "host"
    st = ogg.decode_ogg_flac(data, engine=engine, **CPU)
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, pcm)
    ref = jogg.decode_ogg_flac(data, engine="host")
    np.testing.assert_array_equal(st.samples, ref.samples)
    assert st.total_samples == ref.total_samples


def test_unwrap_is_bit_exact_and_matches():
    stream, _ = _stream(seed=3, n=4096)
    data = _wrap(ogg, stream)
    links, ref = ogg.unwrap_ogg_flac(data), jogg.unwrap_ogg_flac(data)
    assert len(links) == len(ref) == 1
    assert links[0].flac == stream
    assert vars(links[0]) == vars(ref[0])


@pytest.mark.parametrize("entry", ["decode_ogg_flac", "decode_stream_auto"])
def test_chained_links_match(entry):
    s1, p1 = _stream(seed=1, n=4096)
    s2, p2 = _stream(seed=2, n=5000)
    data = _wrap(ogg, s1, serial=1) + _wrap(ogg, s2, serial=2)
    assert data == _wrap(jogg, s1, serial=1) + _wrap(jogg, s2, serial=2)
    if entry == "decode_ogg_flac":
        st = ogg.decode_ogg_flac(data, **CPU)
        ref = jogg.decode_ogg_flac(data, engine="host")
    else:
        # the Ogg branch drops `tolerant`: the Ogg layer has its own resync
        st = decode_stream_auto(data, tolerant=True, **CPU)
        ref = ref_auto(data, tolerant=True, engine="host")
    want = np.concatenate([p1, p2], axis=1)
    np.testing.assert_array_equal(st.samples, want)
    np.testing.assert_array_equal(ref.samples, want)
    assert st.total_samples == ref.total_samples == want.shape[1]


def test_chained_links_must_agree():
    s1, _ = _stream(seed=1, n=4096)
    mono = encode_file_to_flac(make_test_signal(3000, channels=1),
                               EncoderConfig.from_preset(0, blocksize=N,
                                                         channels=1),
                               device="cpu")
    data = _wrap(ogg, s1, serial=1) + _wrap(ogg, mono, serial=2)
    with pytest.raises(ogg.OggError, match="differing"):
        ogg.decode_ogg_flac(data, **CPU)


def test_decode_stream_auto_takes_native_flac_too():
    stream, pcm = _stream(seed=8, n=3000, level=0)
    st = decode_stream_auto(stream, **CPU)
    np.testing.assert_array_equal(st.samples, pcm)


def test_granulepos_on_full_pages_matches():
    """A page on which a packet completes carries the granulepos of the
    last packet completed on it; -1 only on pages that are all
    mid-packet."""
    stream, pcm = _stream(seed=5, n=65536, level=1)
    data = _wrap(ogg, stream)
    assert data == _wrap(jogg, stream)
    pages = [p for p, _ in ogg.read_pages(data)]
    unk = (1 << 64) - 1
    audio = [p for p in pages if p["sequence"] >= 2]
    assert any(len(p["lacing"]) == 255 for p in audio)
    for p in audio:
        if any(lv < 255 for lv in p["lacing"]):
            assert p["granulepos"] != unk
    gs = [p["granulepos"] for p in audio if p["granulepos"] != unk]
    assert gs == sorted(gs) and gs[-1] == pcm.shape[1]


def test_packet_resync_on_continued_page_matches():
    """Dropping the page where a packet starts must not splice its tail
    onto the next packet."""
    out = io.BytesIO()
    w = ogg.PageWriter(out, serial=9)
    w.write_packet(b"head", 0, flush=True)
    w.write_packet(b"A" * 70000, 1, flush=True)
    w.write_packet(b"tailpkt", 2, eos=True)
    pages = [p for p, _ in ogg.read_pages(out.getvalue())]
    start = next(i for i, p in enumerate(pages)
                 if p["sequence"] >= 1 and not p["header_type"] & 0x01
                 and p["segments"][0][:1] == b"A")
    kept = pages[:start] + pages[start + 1:]
    pkts = [pkt for _, pkt, _ in ogg.pages_to_packets(iter(kept))]
    assert pkts == [pkt for _, pkt, _ in jogg.pages_to_packets(iter(kept))]
    assert b"tailpkt" in pkts
    assert all(not p.startswith(b"A") for p in pkts if p != b"head")


def test_unknown_header_count_matches():
    """A header count of 0 means "unknown": the metadata packets that
    follow still count as metadata, up to the one flagged last."""
    stream, pcm = _stream(seed=6, n=4096)
    data = bytearray(_wrap(ogg, stream))
    _first, end = next(ogg.read_pages(bytes(data)))
    body = 27 + data[26]
    data[body + 7:body + 9] = b"\x00\x00"
    page = bytes(data[:end])
    data[22:26] = ogg.crc32_ogg(page[:22] + b"\0\0\0\0"
                                + page[26:]).to_bytes(4, "little")
    data = bytes(data)
    assert vars(ogg.unwrap_ogg_flac(data)[0]) == \
        vars(jogg.unwrap_ogg_flac(data)[0])
    st = ogg.decode_ogg_flac(data, **CPU)
    np.testing.assert_array_equal(st.samples, pcm)


def test_resync_after_garbage():
    stream, pcm = _stream(seed=4, n=4096)
    data = b"JUNK" * 10 + _wrap(ogg, stream)
    st = ogg.decode_ogg_flac(data, **CPU)
    np.testing.assert_array_equal(st.samples, pcm)
    assert vars(ogg.unwrap_ogg_flac(data)[0]) == \
        vars(jogg.unwrap_ogg_flac(data)[0])


@pytest.mark.parametrize("pkg", [jogg, ogg], ids=["flac_tpu", "port"])
def test_not_ogg_flac_raises(pkg):
    with pytest.raises(pkg.OggError, match="no Ogg FLAC stream"):
        pkg.unwrap_ogg_flac(b"nothing here")
    with pytest.raises(pkg.OggError, match="not a FLAC stream"):
        pkg._build_header_pages(b"RIFF" + bytes(60), 0)


@pytest.fixture(scope="module")
def ranged():
    pcm = make_test_signal(4096 * 4 + 100, seed=9)
    flac = encode_file_to_flac(pcm, EncoderConfig.from_preset(3),
                               device="cpu")
    return _wrap(ogg, flac), pcm


@pytest.mark.parametrize("start, n", [(5000, 6000), (0, 1), (4095, 2),
                                      (16384, 100), (16474, 1000),
                                      (17000, 10)])
def test_ranged_decode_matches(ranged, start, n):
    """Only the frame packets covering [start, start + n) are decoded; the
    range past the end clips."""
    data, pcm = ranged
    st = ogg.decode_ogg_flac_range(data, start, n, **CPU)
    np.testing.assert_array_equal(st.samples, pcm[:, start:start + n])
    ref = jogg.decode_ogg_flac_range(data, start, n, engine="host")
    np.testing.assert_array_equal(st.samples, ref.samples)


def _sink_encode(pkg_ogg, enc_cls, cfg, pcm, out, **kw):
    sink = pkg_ogg.OggFlacSink(out)
    with enc_cls(sink, cfg, batch_frames=4, **kw) as enc:
        enc.process(pcm)
        enc.finish()
    sink.finalize()
    return out.getvalue()


def test_streaming_sink_matches():
    """OggFlacSink pages each batch out as it lands and rewrites the header
    pages in place at finish (the STREAMINFO back-patch): the port's pages
    are flac_tpu's byte for byte, and equal the one-shot wrapper of the
    port's native stream."""
    pcm = make_test_signal(N * 11 + 777, seed=12)
    cfg = EncoderConfig.from_preset(1, blocksize=N)
    port = _sink_encode(ogg, StreamEncoder, cfg, pcm, io.BytesIO(), **CPU)
    ref = _sink_encode(jogg, RefEncoder,
                       flac_tpu.EncoderConfig.from_preset(1, blocksize=N),
                       pcm, io.BytesIO())
    assert port == ref
    native = encode_file_to_flac(pcm, cfg, batch_frames=4, **CPU)
    assert port == _wrap(ogg, native)
    st = decode_stream_auto(port, **CPU)
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, pcm)


def test_streaming_sink_to_a_pipe():
    """A non-seekable output: the pages are still valid, and the MD5 stays
    unknown (zeros) because the header cannot be patched."""
    class Pipe(io.BytesIO):
        def seekable(self):
            return False

    pcm = make_test_signal(N * 5 + 10, seed=13)
    data = _sink_encode(ogg, StreamEncoder,
                        EncoderConfig.from_preset(1, blocksize=N), pcm,
                        Pipe(), **CPU)
    st = ogg.decode_ogg_flac(data, verify_md5=False, **CPU)
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.md5 == b"\x00" * 16
    ref = jogg.decode_ogg_flac(data, verify_md5=False, engine="host")
    np.testing.assert_array_equal(ref.samples, pcm)


def test_sink_with_seek_table_and_verify():
    """The sink reports native FLAC positions, so the encoder's seek table
    and verify work through it as on a plain file."""
    from flac_tpu_torch import metadata as md
    pcm = make_test_signal(N * 9 + 5, seed=14)
    cfg = EncoderConfig.from_preset(1, blocksize=N)
    table = md.SeekTableBlock.template_spaced(pcm.shape[1], 44100, 0.05)
    data = _sink_encode(ogg, StreamEncoder, cfg, pcm, io.BytesIO(),
                        verify=True, seektable=table, **CPU)
    native = encode_file_to_flac(
        pcm, cfg, batch_frames=4,
        seektable=md.SeekTableBlock.template_spaced(pcm.shape[1], 44100,
                                                    0.05), **CPU)
    assert ogg.unwrap_ogg_flac(data)[0].flac == native
