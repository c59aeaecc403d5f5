"""flac_tpu_torch.seek.FlacReader against flac_tpu's, on the CPU.

These are the cases of tests/test_seek.py (not the command-line one,
which waits for the port of cli.py).  The inputs are noise streams from
the port's encoder, read with and without a seek table.  The port's reads
take the device path (the "device" engine's plain versions of K2 and K3
on the CPU) and the host path (the native host engine).  Both are held
against the source and against flac_tpu's FlacReader(use_device=False),
which decodes with its native host engine and compiles nothing.
"""

import numpy as np
import pytest
import torch

from flac_tpu import metadata as jmd
from flac_tpu.seek import FlacReader as RefReader
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ref_decoder import FlacDecodeError
from flac_tpu_torch.seek import FlacReader

torch.set_num_threads(1)

N = 1024


def _encode(pcm, seektable=None):
    return encode_file_to_flac(
        pcm, EncoderConfig.from_preset(5, blocksize=N), device="cpu",
        seektable=seektable)


@pytest.fixture(scope="module")
def noise():
    rng = np.random.default_rng(7)
    return rng.integers(-20000, 20000, (2, 44100 * 2)).astype(np.int32)


@pytest.fixture(scope="module")
def stream(noise):
    return _encode(noise)


@pytest.fixture(scope="module")
def stream_with_table(noise):
    return _encode(noise, md.SeekTableBlock.template_spaced(
        noise.shape[1], 44100, 0.25))


def _port(data, path):
    return FlacReader(data, use_device=path == "device", device="cpu")


def _targets(seed, count, hi):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, hi, count)]


@pytest.mark.parametrize("path, reads", [("device", 4), ("host", 30)])
@pytest.mark.parametrize("table", [False, True])
def test_random_reads_match(stream, stream_with_table, noise, path, reads,
                            table):
    """Random read_range calls on one reader equal the source and
    flac_tpu's reader."""
    data = stream_with_table if table else stream
    port, ref = _port(data, path), RefReader(data, use_device=False)
    assert port.total_samples == ref.total_samples == noise.shape[1]
    for t in _targets(3 + table, reads, noise.shape[1] - 100):
        got = port.read_range(t, 100)
        np.testing.assert_array_equal(got, noise[:, t:t + 100])
        np.testing.assert_array_equal(got, ref.read_range(t, 100))
    assert [f["offset"] for f in port._frames] == \
        [f["offset"] for f in ref._frames]


@pytest.mark.parametrize("path", ["device", "host"])
def test_seek_with_table_matches(stream_with_table, noise, path):
    """A fresh reader's seek_absolute jumps to the best seek point, then
    read() goes on from there; the index it builds is flac_tpu's."""
    table = md.Chain.read(stream_with_table).get(md.SeekTableBlock.TYPE)
    assert table.is_legal()
    assert len([p for p in table.points if not p.is_placeholder]) >= 5
    for t in _targets(4, 4 if path == "device" else 10,
                      noise.shape[1] - 64):
        port = _port(stream_with_table, path)
        ref = RefReader(stream_with_table, use_device=False)
        port.seek_absolute(t)
        ref.seek_absolute(t)
        got = port.read(64)
        np.testing.assert_array_equal(got, noise[:, t:t + 64])
        np.testing.assert_array_equal(got, ref.read(64))
        assert port._frames[0]["offset"] == ref._frames[0]["offset"]
    port = _port(stream_with_table, path)
    port.seek_absolute(12345)
    a, b = port.read(64), port.read(64)
    np.testing.assert_array_equal(np.concatenate([a, b], axis=1),
                                  noise[:, 12345:12345 + 128])


def test_seek_table_jump_skips_prefix_scan(stream_with_table, noise):
    target = noise.shape[1] - 2000
    for rd in (_port(stream_with_table, "host"),
               RefReader(stream_with_table, use_device=False)):
        rd.seek_absolute(target)
        assert rd._frames and rd._frames[0]["first_sample"] > 0
        np.testing.assert_array_equal(rd.read(128),
                                      noise[:, target:target + 128])


def test_bad_seek_point_falls_back_to_a_scan(stream_with_table, noise):
    """A seek point whose offset lands on no frame header is not trusted:
    both readers scan from the start instead."""
    ch = md.Chain.read(stream_with_table)
    for p in ch.get(md.SeekTableBlock.TYPE).points:
        if not p.is_placeholder:
            p.stream_offset += 3
    data = ch.write()
    assert len(data) == len(stream_with_table)
    for rd in (_port(data, "host"), RefReader(data, use_device=False)):
        rd.seek_absolute(30000)
        assert rd._frames == [] or rd._frames[0]["first_sample"] == 0
        np.testing.assert_array_equal(rd.read(77), noise[:, 30000:30077])


@pytest.mark.parametrize("path", ["device", "host"])
def test_read_range_tail_short(stream, noise, path):
    got = _port(stream, path).read_range(noise.shape[1] - 50, 1000)
    assert got.shape == (2, 50)
    np.testing.assert_array_equal(got, noise[:, -50:])
    ref = RefReader(stream, use_device=False).read_range(
        noise.shape[1] - 50, 1000)
    np.testing.assert_array_equal(got, ref)


def test_read_range_past_the_end_is_empty(stream, noise):
    for rd in (_port(stream, "host"), RefReader(stream, use_device=False)):
        assert rd.read_range(noise.shape[1], 10).shape == (2, 0)


def test_seek_past_end_raises(stream, noise):
    with pytest.raises(FlacDecodeError, match="past end"):
        _port(stream, "host").seek_absolute(noise.shape[1])
    with pytest.raises(Exception, match="past end"):
        RefReader(stream, use_device=False).seek_absolute(noise.shape[1])


def test_missing_marker_raises():
    with pytest.raises(FlacDecodeError, match="fLaC"):
        FlacReader(b"RIFF" + bytes(40), device="cpu")


def test_seek_points_land_on_frame_boundaries(noise):
    """Each resolved point of a count template lands on a frame whose first
    sample it names; its reads equal the source and flac_tpu's."""
    data = _encode(noise, md.SeekTableBlock.template_count(10,
                                                           noise.shape[1]))
    table = md.Chain.read(data).get(md.SeekTableBlock.TYPE)
    assert jmd.Chain.read(data).get(md.SeekTableBlock.TYPE).to_bytes() == \
        table.to_bytes()
    port, ref = _port(data, "host"), RefReader(data, use_device=False)
    real = [p for p in table.points if not p.is_placeholder]
    assert len(real) == 10
    for p in real:
        assert p.sample_number % N == 0
        got = port.read_range(p.sample_number, 32)
        np.testing.assert_array_equal(
            got, noise[:, p.sample_number:p.sample_number + 32])
        np.testing.assert_array_equal(got, ref.read_range(p.sample_number,
                                                          32))


def test_reader_defaults_to_the_gpu(stream):
    """use_device=True with no device means "cuda": without a GPU the
    reader raises rather than decode on the CPU.  The host path needs no
    device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the reader would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlacReader(stream)
    assert FlacReader(stream, use_device=False).read_range(0, 10).shape == \
        (2, 10)
