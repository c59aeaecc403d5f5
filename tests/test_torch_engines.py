"""The port's four decode engines ("device", "fast", "scan", "host") and
"auto", on the CPU, against each other and flac_tpu's host engine.

The streams of tests/test_decoder_fast.py at blocksize 1152 (the eager
"scan" engine takes a sample step over every frame at a time): the mixed
stream (constant, wasted-bit, fixed and LPC subframes), preset -0 (fixed
predictors), the 32-bit stream with a 33-bit side channel (wide lanes,
encoded by flac_tpu and checked to hold a 33-bit side subframe), the
false-sync repair and a corrupt stream that stays corrupt; then the
"auto" engine's model under a pinned FLAC_TPU_LINK_MBPS.  On the CPU the
kernels' wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as RefConfig
from flac_tpu import native as jnative
from flac_tpu.decoder import decode_frame_list as ref_frame_list
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu.encoder import encode_file_to_flac as ref_encode
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, signals
from flac_tpu_torch import decoder as dec
from flac_tpu_torch import format as fmt
from flac_tpu_torch.decoder_fast import _group_arrays
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ops.crc import crc8, crc16
from flac_tpu_torch.ref_decoder import FlacDecodeError, parse_metadata
from flac_tpu_torch.utils.bits import BitWriter

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not jnative.AVAILABLE,
                                reason="flac_tpu's native runtime is "
                                       "unavailable")

ENGINES = ("device", "fast", "scan", "host")
N = 1152


def _mixed():
    """Constant, wasted-bit, fixed and LPC subframes (test_decoder_fast's
    mixed stream at blocksize 1152, with a short last frame)."""
    pcm = signals.make_test_signal(N * 3 + 500, seed=3)
    pcm[:, :N // 2] = -5                    # constant region
    pcm[:, N // 2:N] &= ~np.int32(0xF)      # wasted bits
    return pcm, encode_file_to_flac(pcm, EncoderConfig.from_preset(
        8, blocksize=N), device="cpu")


def _preset0():
    pcm = signals.make_test_signal(N * 2, seed=4)
    return pcm, encode_file_to_flac(pcm, EncoderConfig.from_preset(
        0, blocksize=N), device="cpu")


def _wide32():
    """bps 32 mid/side: 33-bit side subframes, int64 residuals."""
    rng = np.random.default_rng(7)
    base = rng.normal(0, 2 ** 27, N * 2).astype(np.int64)
    left = np.clip(base, -2**31, 2**31 - 1)
    right = np.clip(base + rng.normal(0, 2 ** 24, N * 2).astype(np.int64),
                    -2**31, 2**31 - 1)
    pcm = np.stack([left, right]).astype(np.int32)
    cfg = RefConfig.from_preset(5, bits_per_sample=32, blocksize=N)
    return pcm, ref_encode(pcm, cfg, batch_frames=2)


STREAMS = {"mixed": _mixed, "preset -0": _preset0, "wide 32-bit": _wide32}


@pytest.mark.parametrize("name", list(STREAMS))
def test_engines_agree_bitexact(name):
    pcm, data = STREAMS[name]()
    if name == "wide 32-bit":
        st, pos = parse_metadata(data, 4)
        frames = dec.scan_frames(data, st, pos)
        ch_bps = _group_arrays(frames, range(len(frames)), 2)[4]
        assert (ch_bps == 33).any(), "no 33-bit side subframe"
    want = ref_decode(data, engine="host").samples
    np.testing.assert_array_equal(want, pcm)
    for engine in ENGINES:
        st = decode_stream_tpu(data, engine=engine, device="cpu")
        np.testing.assert_array_equal(st.samples, want, err_msg=engine)
        assert st.md5_ok, engine


def test_frame_lists_agree_with_flac_tpu():
    """decode_frame_list per frame, each engine against flac_tpu's host
    engine; decode_frames_selected on a run of frames."""
    pcm, data = _mixed()
    st, pos = parse_metadata(data, 4)
    frames = dec.scan_frames(data, st, pos)
    want = ref_frame_list(data, st, frames, engine="host")
    for engine in ENGINES:
        got = dec.decode_frame_list(data, st, frames, device="cpu",
                                    engine=engine)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=engine)
    run = dec.decode_frames_selected(data, st, frames[1:3], device="cpu")
    np.testing.assert_array_equal(run, pcm[:, N:3 * N])


def _false_sync_stream():
    """A verbatim frame whose payload holds a byte pattern that scans as
    the next frame's header, then two constant frames (test_decoder_fast's
    craft, blocksize 192, mono 16-bit)."""
    n = 192
    fake = bytes([0xFF, 0xF8, 0x19, 0x08, 0x01])
    fake += bytes([crc8(fake)])
    samples = np.random.default_rng(3).integers(-30000, 30000, n)
    for j in range(3):
        v = (fake[2 * j] << 8) | fake[2 * j + 1]
        samples[16 + j] = v - 65536 if v >= 32768 else v

    def frame(number, subframe):
        bw = BitWriter()
        bw.write(0b11111111111110, 14)
        bw.write(0, 2)
        bw.write(1, 4)                   # blocksize 192
        bw.write(9, 4)                   # 44100
        bw.write(0, 4)                   # mono
        bw.write(0b100, 3)               # bps 16
        bw.write(0, 1)
        bw.write(number, 8)
        bw.write(crc8(bw.getvalue()), 8)
        subframe(bw)
        bw.pad_to_byte()
        bw.write(crc16(bw.getvalue()), 16)
        return bw.getvalue()

    def verbatim(bw):
        bw.write(0x02, 8)
        for s in samples:
            bw.write(int(s) & 0xFFFF, 16)

    def const(value):
        def sub(bw):
            bw.write(0x00, 8)
            bw.write(value & 0xFFFF, 16)
        return sub

    si = BitWriter()
    si.write(n, 16)
    si.write(n, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(44100, 20)
    si.write(0, 3)
    si.write(15, 5)
    si.write(3 * n, 36)
    si.write_bytes(b"\x00" * 16)
    info = si.getvalue()
    hdr = (1 << 31) | (fmt.METADATA_TYPE_STREAMINFO << 24) | len(info)
    stream = (fmt.STREAM_SYNC_STRING + hdr.to_bytes(4, "big") + info
              + frame(0, verbatim) + frame(1, const(100))
              + frame(2, const(-7)))
    return stream, samples, fake


def test_false_sync_repair_strict():
    stream, samples, fake = _false_sync_stream()
    st, pos = parse_metadata(stream, 4)
    assert any(f["offset"] == stream.index(fake)
               for f in dec.scan_frames(stream, st, pos)), \
        "the fake header was not scanned as a frame"
    want = ref_decode(stream, verify_md5=False, engine="host").samples
    np.testing.assert_array_equal(want[0, :192], samples)
    for engine in ENGINES:
        st = decode_stream_tpu(stream, verify_md5=False, engine=engine,
                               device="cpu")
        np.testing.assert_array_equal(st.samples, want, err_msg=engine)


def test_corrupt_stays_corrupt_after_repair():
    pcm = signals.make_test_signal(N * 2, seed=5)
    data = bytearray(encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, blocksize=N), device="cpu"))
    data[-40] ^= 0x10
    with pytest.raises(Exception):
        ref_decode(bytes(data), engine="host")
    for engine in ENGINES:
        with pytest.raises(FlacDecodeError):
            decode_stream_tpu(bytes(data), engine=engine, device="cpu")


# ---------------------------------------------------------------------------
# "auto"
# ---------------------------------------------------------------------------

def _frames(pcm_mb: float):
    """A frame table of pcm_mb MB of 16-bit stereo PCM (4096-sample
    frames); the model reads only blocksize and channels."""
    n = int(pcm_mb * 1e6 / (4096 * 2 * 2)) + 1
    return [dict(blocksize=4096, channels=2)] * n


@pytest.mark.parametrize("mbps, cores", [(1.0, 8), (1e6, 1), (1e6, 8),
                                         (150.0, 2)])
def test_pick_engine_under_a_pinned_link(monkeypatch, mbps, cores):
    monkeypatch.setenv("FLAC_TPU_LINK_MBPS", str(mbps))
    monkeypatch.setattr(dec.os, "cpu_count", lambda: cores)
    cuda = torch.device("cuda")          # the probe is pinned: no GPU used
    assert dec.probe_link_bandwidth(cuda) == mbps
    rates = {"host": dec._HOST_DECODE_MBPS_PER_CORE * min(cores, 8),
             "device": min(dec._DEVICE_DECODE_MBPS, mbps / 1.6),
             "fast": min(dec._FAST_DECODE_MBPS, mbps / 2.0)}
    want = max(rates, key=rates.get)
    assert dec._pick_engine(_frames(40), cuda) == want
    if mbps == 1.0:
        assert want == "host"
    # small streams, and any stream on a CPU device, go to the host engine
    assert dec._pick_engine(_frames(10), cuda) == "host"
    assert dec._pick_engine(_frames(40), torch.device("cpu")) == "host"


def test_probe_is_inf_on_the_cpu(monkeypatch):
    monkeypatch.delenv("FLAC_TPU_LINK_MBPS", raising=False)
    assert dec.probe_link_bandwidth("cpu") == float("inf")


def test_auto_decodes():
    pcm, data = _preset0()
    st = decode_stream_tpu(data, engine="auto", device="cpu")
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.md5_ok
