"""The port's device decode engine end to end on the CPU.

The cases of tests/test_device_engine.py, each encoded by the port (the
32-bit one by flac_tpu, and checked to hold a 33-bit side subframe),
decoded by `flac_tpu_torch.decode_stream_tpu(engine="device",
device="cpu")`: the samples must equal the source with a matching MD5, and
equal flac_tpu's host engine and the port's own.  On the CPU the code scan
runs its plain version; the kernel is held against it on the GPU
(test_torch_rice_cuda.py).
"""

import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as RefConfig
from flac_tpu import native as jnative
from flac_tpu.decoder import decode_frame_list as ref_frame_list
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu.encoder import encode_file_to_flac as ref_encode
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, native
from flac_tpu_torch.decoder import decode_frame_list, scan_frames
from flac_tpu_torch.decoder_fast import _group_arrays
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ref_decoder import FlacDecodeError, parse_metadata

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not jnative.AVAILABLE,
                                reason="flac_tpu's native runtime is "
                                       "unavailable")


def _tone(n, scale):
    t = np.arange(n) / 44100.0
    return np.sin(2 * np.pi * 440.0 * t) * scale


def _case(name):
    """(pcm, bps, preset, config overrides) of a test_device_engine case."""
    rng = np.random.default_rng(11)
    if name == "16-bit stereo partial tail":
        n = 4096 * 4 + 1234
        p = np.round(_tone(n, 12000) + 300 * rng.standard_normal(n))
        return np.stack([p, np.roll(p, 5)]).astype(np.int32), 16, 8, {}
    if name == "wasted bits":
        p = (np.round(_tone(4096 * 3, 120)) * 256).astype(np.int32)
        return np.stack([p, -p]), 16, 8, {}
    if name == "24-bit":
        n = 4096 * 3 + 100
        p = np.round(_tone(n, 1 << 22) + 1000 * rng.standard_normal(n))
        return np.stack([p, np.roll(p, 7)]).astype(np.int32), 24, 8, {}
    if name == "8-bit mono":
        return np.round(_tone(4096 * 2, 100)).astype(np.int32)[None], 8, 8, {}
    if name.startswith("noise"):
        pcm = rng.integers(-30000, 30000, (2, 4096 * 2 + 77),
                           np.int64).astype(np.int32)
        return pcm, 16, 0 if name == "noise -0" else 8, {}
    if name == "blocksize 192":
        p = np.round(_tone(700, 5000)).astype(np.int32)
        return np.stack([p, p]), 16, 8, {"blocksize": 192}
    if name == "constant":
        pcm = np.zeros((2, 4096 * 2), np.int32)
        pcm[:, 4096:] = 777          # constant subframes both ways
        return pcm, 16, 8, {}
    if name == "6 channels":
        base = _tone(4096 * 2, 3000)
        return np.stack([np.round(base * s).astype(np.int32)
                         for s in (1, 2, 3, -1, -2, 0.5)]), 16, 8, {}
    if name == "host fallback":
        # partition order 8: more segments a tile than the table holds, so
        # every frame is decoded again by the host
        n = 4096 * 2 + 500
        p = np.round(_tone(n, 9000) + 200 * rng.standard_normal(n))
        return (np.stack([p, np.roll(p, 3)]).astype(np.int32), 16, 5,
                {"min_residual_partition_order": 8,
                 "max_residual_partition_order": 8})
    raise KeyError(name)


CASES = ["16-bit stereo partial tail", "wasted bits", "24-bit",
         "8-bit mono", "noise -8", "noise -0", "blocksize 192", "constant",
         "6 channels", "host fallback"]


def _check(stream, pcm, label):
    dev = decode_stream_tpu(stream, engine="device", device="cpu")
    np.testing.assert_array_equal(dev.samples, pcm, err_msg=label)
    assert dev.md5_ok, label
    ref = ref_decode(stream, engine="host")
    np.testing.assert_array_equal(dev.samples, ref.samples, err_msg=label)
    host = decode_stream_tpu(stream, engine="host", device="cpu")
    np.testing.assert_array_equal(host.samples, pcm, err_msg=label)


@pytest.mark.parametrize("name", CASES)
def test_device_engine_case(name):
    pcm, bps, preset, kw = _case(name)
    cfg = EncoderConfig.from_preset(preset, bits_per_sample=bps,
                                    channels=pcm.shape[0], **kw)
    stream = encode_file_to_flac(pcm, cfg, device="cpu")
    _check(stream, pcm, name)


def test_host_fallback_case_overflows_the_tables():
    """The fallback case really sends its frames to the host decoder."""
    pcm, bps, preset, kw = _case("host fallback")
    stream = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        preset, **kw), device="cpu")
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    full = [i for i, f in enumerate(frames) if f["blocksize"] == 4096]
    off, sb, sz, _, ch_bps = _group_arrays(frames, full, 2)
    tg = native.tile_scan(np.frombuffer(stream, np.uint8), off, sb, sz,
                          ch_bps, 4096)
    assert (tg.status == native.FT_SEG_OVERFLOW).all()


def test_device_engine_32bit_wide_side():
    """32-bit stereo with a 33-bit side channel: wide lanes, int64 codes."""
    n = 4096 * 2
    rng = np.random.default_rng(11)
    p = np.clip(np.round(_tone(n, 1 << 30)
                         + (1 << 20) * rng.standard_normal(n)),
                -(1 << 31), (1 << 31) - 1)
    pcm = np.stack([p, np.roll(p, 3)]).astype(np.int32)
    cfg = RefConfig.from_preset(8, bits_per_sample=32, channels=2,
                                streamable_subset=False).resolve()
    stream = ref_encode(pcm, cfg)
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    ch_bps = _group_arrays(frames, range(len(frames)), 2)[4]
    assert (ch_bps == 33).any(), "no 33-bit side subframe"
    _check(stream, pcm, "32-bit wide")


def test_device_engine_crc_error_detected():
    p = np.round(_tone(4096 * 4, 12000)).astype(np.int32)
    pcm = np.stack([p, p])
    stream = bytearray(encode_file_to_flac(
        pcm, EncoderConfig.from_preset(5), device="cpu"))
    st, pos = parse_metadata(bytes(stream), 4)
    frames = scan_frames(bytes(stream), st, pos)
    stream[frames[2]["offset"] + frames[2]["size"] // 2] ^= 0x10
    with pytest.raises(FlacDecodeError, match="CRC16|MD5|lost sync"):
        decode_stream_tpu(bytes(stream), engine="device", device="cpu")


def _corrupt(at_frame: int, where):
    """A -5 stream and its source with one byte of frame `at_frame`
    flipped at where(frame)."""
    p = np.round(_tone(4096 * 4, 12000)).astype(np.int32)
    pcm = np.stack([p, -p])
    stream = bytearray(encode_file_to_flac(
        pcm, EncoderConfig.from_preset(5), device="cpu"))
    st, pos = parse_metadata(bytes(stream), 4)
    f = scan_frames(bytes(stream), st, pos)[at_frame]
    stream[where(f)] ^= 0x10
    return bytes(stream), pcm


def test_drop_leaves_the_bad_frame_out():
    """on_crc_error="drop": the corrupt frame's slot stays None and its
    number is recorded, the other frames decode, as in flac_tpu."""
    stream, pcm = _corrupt(2, lambda f: f["offset"] + f["size"] // 2)
    out = []
    for decode in (lambda *a, **k: decode_frame_list(*a, device="cpu", **k),
                   lambda *a, **k: ref_frame_list(*a, engine="host", **k)):
        st, pos = parse_metadata(stream, 4)
        frames = scan_frames(stream, st, pos)
        st.errors = []
        res = decode(stream, st, frames, on_crc_error="drop")
        out.append((res, [n for _, n in st.errors]))
    (got, got_err), (want, want_err) = out
    assert got_err == want_err == [2]
    assert got[2] is None and want[2] is None
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], pcm[:, i * 4096:(i + 1) * 4096])


def test_verify_crc_false_ignores_a_bad_frame_crc():
    """A flipped bit in a frame's CRC-16 trailer: rejected by default,
    decoded (with the MD5 intact) when CRC checks are off."""
    stream, pcm = _corrupt(1, lambda f: f["offset"] + f["size"] - 1)
    with pytest.raises(FlacDecodeError, match="CRC16"):
        decode_stream_tpu(stream, device="cpu")
    st = decode_stream_tpu(stream, device="cpu", verify_crc=False)
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.md5_ok


def test_decode_batches_split_by_max_batch():
    """Several batches per (blocksize, channels) group, committed in order
    through the pipeline, hash in stream order."""
    pcm, bps, preset, kw = _case("16-bit stereo partial tail")
    stream = encode_file_to_flac(pcm, EncoderConfig.from_preset(5),
                                 device="cpu")
    st = decode_stream_tpu(stream, device="cpu", max_batch=2)
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.md5_ok
