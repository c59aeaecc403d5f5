"""The 33-bit side channel (bps 32 with mid-side stereo) in flac_tpu_torch
against flac_tpu, on the CPU.

These are the 32-bit cases of tests/test_hires.py: the seeded 32-bit
music of test_32bit_roundtrip_oracle, the full-scale pattern of
test_32bit_extreme_values, the constant 33-bit side of
test_32bit_constant_33bit_side and the correlated stereo of
test_32bit_mid_side_beats_independent; and antiphase stereo (R = -L),
whose mid-side frames carry side samples past 2^31.  At -0, -1 and -2
the port's streams are byte-identical to flac_tpu's, at -5 within 0.1% of
their size; each decodes with its MD5 through flac_tpu's reference
decoder and the port's host, "device" and "fast" engines (the plain
versions of K2 and K3), and at -1 its "scan" engine too.

Every encode runs one frame a batch at blocksize 1152, so flac_tpu
compiles one batch shape for each preset.
"""

import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as RefConfig
from flac_tpu.ref_decoder import decode_stream as ref_decode
from flac_tpu.encoder import encode_file_to_flac as ref_encode
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, signals
from flac_tpu_torch.encoder import encode_file_to_flac

torch.set_num_threads(1)

N = 1152
RATE = 96000


def _extreme(n):
    pcm = np.zeros((2, n), np.int32)
    pcm[0, ::2] = (1 << 31) - 1
    pcm[0, 1::2] = -(1 << 31)
    pcm[1, ::4] = (1 << 31) - 1
    pcm[1, 2::4] = -(1 << 31)
    return pcm


def _constant_side(n):
    pcm = np.zeros((2, n), np.int32)
    pcm[0, :] = (1 << 31) - 1
    pcm[1, :] = -(1 << 31)          # side = constant 2^32 - 1 (33-bit)
    return pcm


def _correlated(n):
    rng = np.random.default_rng(3)
    t = np.arange(n) / RATE
    base = (np.sin(2 * np.pi * 440 * t) * (1 << 30)).astype(np.int64)
    noise = rng.integers(-(1 << 12), 1 << 12, n)
    return np.stack([np.clip(base + sign * noise, -(1 << 31), (1 << 31) - 1)
                     for sign in (1, -1)]).astype(np.int32)


def _antiphase(n):
    left = np.round(1.6e9 * np.sin(np.arange(n) * 0.01)).astype(np.int64)
    return np.stack([left, -left]).astype(np.int32)


SIGNALS = {
    "antiphase": lambda: _antiphase(N * 2),
    "music": lambda: signals.make_hires32_signal(N * 4),
    "full scale": lambda: _extreme(N * 2),
    "constant side": lambda: _constant_side(N * 2),
    "correlated": lambda: _correlated(N * 3),
}


def _cfg(pkg, level, **kw):
    return pkg.from_preset(level, sample_rate=RATE, channels=2,
                           bits_per_sample=32, blocksize=N, **kw)


def _encode_both(pcm, level, **kw):
    ours = encode_file_to_flac(pcm, _cfg(EncoderConfig, level, **kw),
                               batch_frames=1, device="cpu")
    ref = ref_encode(pcm, _cfg(RefConfig, level, **kw), batch_frames=1)
    return ours, ref


def _decodes(stream, pcm, engines=("host", "scan", "device", "fast")):
    """Every decode gives pcm back with the MD5; returns the frames'
    channel assignments."""
    ref = ref_decode(stream)                # raises on an MD5 mismatch
    np.testing.assert_array_equal(ref.samples, pcm)
    for engine in engines:
        st = decode_stream_tpu(stream, engine=engine, device="cpu")
        assert st.md5_ok, engine
        np.testing.assert_array_equal(st.samples, pcm, err_msg=engine)
    return [f["assignment"] for f in ref.frames]


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_byte_identical_at_fast_presets(kind, level):
    pcm = SIGNALS[kind]()
    ours, ref = _encode_both(pcm, level)
    assert ours == ref
    if level == 1:
        _decodes(ours, pcm)


@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_size_at_preset_5(kind):
    pcm = SIGNALS[kind]()
    ours, ref = _encode_both(pcm, 5)
    assert abs(len(ours) - len(ref)) <= 0.001 * len(ref), (len(ours),
                                                           len(ref))
    assignments = _decodes(ours, pcm, ("host", "device", "fast"))
    if kind in ("correlated", "antiphase"):
        assert set(assignments) - {0}, "no frame chose a side channel"


def test_mid_side_beats_independent():
    """The 33-bit side is encoded at bps=32 and wins on correlated stereo
    (test_hires.py::test_32bit_mid_side_beats_independent)."""
    pcm = _correlated(N * 3)
    assert _cfg(EncoderConfig, 5).resolve().max_subframe_bps == 33
    ms = encode_file_to_flac(pcm, _cfg(EncoderConfig, 5), device="cpu")
    ind = encode_file_to_flac(pcm, _cfg(EncoderConfig, 5,
                                        do_mid_side=False), device="cpu")
    assert len(ms) < len(ind)
