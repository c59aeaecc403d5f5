"""Tolerant decoding in the port (the `flac -F` recovery of
stream_decoder.c), against flac_tpu's tolerant decode on the same bytes.

The cases of tests/test_resilience.py: an ID3v2 tag, a frame with a
corrupt payload (dropped and concealed), a frame cut out of the stream
(silence in its place), a stream that starts mid-way (no fLaC marker), and
one whose metadata is stripped.  The samples and st.errors must equal
flac_tpu's, for each of the port's engines.  The `flac -F` oracle case
needs the libFLAC binary and stays in test_resilience.py.
"""

import io

import numpy as np
import pytest
import torch

from flac_tpu import native as jnative
from flac_tpu import ogg as jogg
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, ogg, signals
from flac_tpu_torch.decoder import decode_stream_auto, skip_id3v2
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ref_decoder import FlacDecodeError

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not jnative.AVAILABLE,
                                reason="flac_tpu's native runtime is "
                                       "unavailable")

N = 1024


@pytest.fixture(scope="module")
def stream():
    pcm = signals.make_test_signal(N * 12, seed=12)
    return pcm, encode_file_to_flac(
        pcm, EncoderConfig.from_preset(3, blocksize=N), device="cpu")


def _offsets(data):
    st = decode_stream_tpu(data, verify_md5=False, engine="host",
                           device="cpu")
    return [(f["offset"], f["size"]) for f in st.frames]


def _id3v2(pcm, data):
    size = 500
    tag = (b"ID3\x04\x00\x00"
           + bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F,
                    (size >> 7) & 0x7F, size & 0x7F])
           + b"\xff" * size)        # junk payload with fake sync bytes
    assert skip_id3v2(tag + data) == 10 + size
    return tag + data


def _crc_error(pcm, data):
    off, size = _offsets(data)[2]
    bad = bytearray(data)
    bad[off + size // 2] ^= 0x10     # inside the third frame's payload
    return bytes(bad)


def _missing_frame(pcm, data):
    off, size = _offsets(data)[4]
    return data[:off] + data[off + size:]


def _midstream(pcm, data):
    return data[_offsets(data)[3][0]:]


def _no_streaminfo(pcm, data):
    return data[_offsets(data)[0][0]:]


CASES = {"id3v2": _id3v2, "crc error": _crc_error,
         "missing frame": _missing_frame, "mid-stream start": _midstream,
         "no STREAMINFO": _no_streaminfo}


@pytest.mark.parametrize("engine", ["device", "fast", "host"])
@pytest.mark.parametrize("case", list(CASES))
def test_tolerant_decode_matches_flac_tpu(stream, case, engine):
    pcm, data = stream
    damaged = CASES[case](pcm, data)
    want = ref_decode(damaged, tolerant=True, engine="host")
    got = decode_stream_tpu(damaged, tolerant=True, engine=engine,
                            device="cpu")
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.errors == want.errors
    assert got.md5_ok == want.md5_ok
    assert (got.sample_rate, got.bits_per_sample, got.channels) == \
        (want.sample_rate, want.bits_per_sample, want.channels)


def test_tolerant_scan_engine_conceals_a_bad_frame(stream):
    """The "scan" engine's own CRC-16 check drops the frame."""
    pcm, data = stream
    damaged = _crc_error(pcm, data)
    want = ref_decode(damaged, tolerant=True, engine="host")
    got = decode_stream_tpu(damaged, tolerant=True, engine="scan",
                            device="cpu")
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.errors == want.errors
    assert ("FRAME_CRC_MISMATCH", 2) in got.errors and not got.md5_ok
    assert np.all(got.samples[:, 2 * N:3 * N] == 0)


def test_concealment_keeps_the_rest(stream):
    """Silence where the bad and the missing frame were, the source
    everywhere else, and strict mode still raises."""
    pcm, data = stream
    damaged = _crc_error(pcm, data)
    with pytest.raises(FlacDecodeError, match="CRC16|MD5"):
        decode_stream_tpu(damaged, device="cpu")
    st = decode_stream_tpu(damaged, tolerant=True, device="cpu")
    mask = np.ones(pcm.shape[1], bool)
    mask[2 * N:3 * N] = False
    assert np.array_equal(st.samples[:, mask], pcm[:, mask])
    st = decode_stream_tpu(_missing_frame(pcm, data), tolerant=True,
                           device="cpu")
    assert any(e[0] == "MISSING_FRAME" for e in st.errors)
    assert st.samples.shape == pcm.shape
    assert np.all(st.samples[:, 4 * N:5 * N] == 0)


def test_decode_stream_auto(stream):
    pcm, data = stream
    st = decode_stream_auto(data, device="cpu")
    np.testing.assert_array_equal(st.samples, pcm)
    st = decode_stream_auto(_midstream(pcm, data), tolerant=True,
                            device="cpu")
    np.testing.assert_array_equal(st.samples, pcm[:, 3 * N:])
    # Ogg input goes to the Ogg layer (tolerant is dropped there): a
    # wrapped stream decodes; a bad page header raises as in flac_tpu
    out = io.BytesIO()
    ogg.wrap_flac_stream(data, out)
    st = decode_stream_auto(out.getvalue(), tolerant=True, device="cpu")
    np.testing.assert_array_equal(st.samples, pcm)
    for pkg, kw in ((ogg, {"device": "cpu"}), (jogg, {"engine": "host"})):
        with pytest.raises(pkg.OggError, match="unsupported Ogg version"):
            pkg.decode_ogg_flac(b"OggS" + data, **kw)
    with pytest.raises(ogg.OggError, match="unsupported Ogg version"):
        decode_stream_auto(b"OggS" + data, device="cpu")
