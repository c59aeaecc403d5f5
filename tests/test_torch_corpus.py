"""The signal corpus and helpers of the whole-slice stream tests
(test_torch_stream_*.py), with a check that the port's signal recipe is
the tests' own.

The corpus is 2 s of music, silence, a click/square-burst signal that
sends frames through the safe re-encode of quad misfits, mono and 24-bit,
each with a short final block.
"""

import io

import numpy as np
import torch

import flac_tpu
from flac_tpu import ref_decoder as jref
from flac_tpu_torch import EncoderConfig as TConfig
from flac_tpu_torch import signals
from flac_tpu_torch.encoder import StreamEncoder

from conftest import make_test_signal

# xdist runs several workers side by side, each with JAX's own threads;
# one torch thread a worker keeps the port's many small CPU ops from
# oversubscribing the cores
torch.set_num_threads(1)

RATE = 44100
BLOCKSIZE = 1024
N_SAMPLES = 2 * RATE            # 86 full blocks and a final block of 136


def corpus(kind):
    n = N_SAMPLES
    if kind == "music":
        return signals.make_test_signal(n, seed=1)
    if kind == "silence":
        return np.zeros((2, n), np.int32)
    if kind == "burst":
        return signals.make_transient_signal(n, seed=3)
    if kind == "mono":
        return signals.make_test_signal(n, channels=1, seed=4)
    if kind == "hires":
        return signals.make_test_signal(n, bps=24, seed=5)
    raise ValueError(kind)


def _config_kw(pcm, cfg_kw):
    bps = 24 if np.abs(pcm).max() >= 1 << 15 else 16
    return dict(blocksize=BLOCKSIZE, channels=pcm.shape[0],
                bits_per_sample=bps, **cfg_kw)


def encode_port(pcm, level, **cfg_kw):
    """(flac_tpu_torch's stream on the CPU, its StreamEncoder) for one
    preset."""
    buf = io.BytesIO()
    enc = StreamEncoder(buf, TConfig.from_preset(level,
                                                 **_config_kw(pcm, cfg_kw)),
                        device="cpu", batch_frames=128)
    enc.process(pcm)
    enc.finish()
    return buf.getvalue(), enc


def encode_both(pcm, level, **cfg_kw):
    """(flac_tpu's stream, flac_tpu_torch's stream on the CPU, the port's
    StreamEncoder) for one preset."""
    ref = flac_tpu.encode_file_to_flac(
        pcm, flac_tpu.EncoderConfig.from_preset(level,
                                                **_config_kw(pcm, cfg_kw)),
        batch_frames=128)
    return (ref, *encode_port(pcm, level, **cfg_kw))


def assert_byte_identical(level, kind):
    """At -0..-2 (no LPC, so no float analysis decides anything) the port
    writes flac_tpu's bytes, STREAMINFO included, and they decode back."""
    pcm = corpus(kind)
    ref, port, enc = encode_both(pcm, level)
    assert port == ref
    st = jref.decode_stream(port)
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.frames[-1]["blocksize"] == N_SAMPLES % BLOCKSIZE
    if kind == "burst":
        assert enc.misfit_frames > 0     # the safe re-encode ran


def differing_frames(ref, port):
    """{frame index: (reference subframes, port subframes)} of the frames
    whose bytes differ."""
    a, b = jref.decode_stream(ref), jref.decode_stream(port)
    assert len(a.frames) == len(b.frames)
    out = {}
    for i, (fa, fb) in enumerate(zip(a.frames, b.frames)):
        if (ref[fa["offset"]:fa["offset"] + fa["size"]]
                != port[fb["offset"]:fb["offset"] + fb["size"]]):
            out[i] = (fa["subframes"], fb["subframes"])
    return out


# (preset, signal) -> {frame index: why its subframe choice differs from
# flac_tpu's}; on this corpus there is none
KNOWN_DIFFERENT: dict = {}


def assert_round_trip_and_size(level, kind):
    """At -3..-8 float analysis (autocorrelation, Levinson, the order
    guess) picks the LPC models, and XLA and torch sum float32 products in
    different orders, so a frame on a borderline could take another model.
    The port's stream must decode bit-exact with the STREAMINFO MD5 and
    come within 0.1% of flac_tpu's size; each frame whose bytes differ must
    be listed in KNOWN_DIFFERENT, and the others are byte-identical."""
    pcm = corpus(kind)
    ref, port, enc = encode_both(pcm, level)
    st = jref.decode_stream(port, verify_md5=True)
    assert st.md5 != b"\x00" * 16
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.frames[-1]["blocksize"] == N_SAMPLES % BLOCKSIZE
    assert abs(len(port) - len(ref)) <= 0.001 * len(ref)
    diff = differing_frames(ref, port)
    expected = KNOWN_DIFFERENT.get((level, kind), {})
    assert set(diff) == set(expected), diff
    if not expected:
        assert port == ref
    if kind == "burst":
        assert enc.misfit_frames > 0     # the safe re-encode ran


def test_signal_recipe_is_the_tests():
    for kw in ({}, {"channels": 1, "bps": 24, "seed": 9}):
        np.testing.assert_array_equal(signals.make_test_signal(5000, **kw),
                                      make_test_signal(5000, **kw))
