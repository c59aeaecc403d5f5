"""The plain reference: a stream the port writes on the CPU reads back to
its input; one flipped bit, a changed input sample, a dropped frame or a
wrong MD5 is caught."""

import io
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import reference, traffic

SEED = 2**31 + 4242
CONTENT = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                      / "clips.json").read_text())["content"]
# transients and pauses: what a mix may add to the recipe
BURSTS = dict(CONTENT, bursts={"per_s": 4, "level": 1.5, "decay_ms": 15},
              pauses={"share": 0.3, "seconds": 0.05, "floor": 0.01})


def encode(pcm, level, rate, bps):
    from flac_tpu_torch.config import EncoderConfig
    from flac_tpu_torch.encoder import StreamEncoder
    cfg = EncoderConfig.from_preset(level, sample_rate=rate,
                                    bits_per_sample=bps,
                                    channels=pcm.shape[0])
    out = io.BytesIO()
    enc = StreamEncoder(out, cfg, device="cpu")
    enc.process(pcm)
    enc.finish()
    return out.getvalue()


def check(stream, pcm, rate, bps):
    r = reference.check_stream(stream, pcm, bps=bps, rate=rate,
                               blocksize=4096, device="cpu")
    return {k: r[k] for k in ("bad_frames", "bad_samples", "md5_bad",
                              "info_bad")}


CASES = [(5, 44100, 16, 2, 3 * 4096 + 1234, CONTENT),
         (8, 96000, 24, 2, 2 * 4096 + 77, CONTENT),
         (0, 44100, 16, 2, 4096 + 5, CONTENT),
         (5, 44100, 16, 1, 2 * 4096 + 9, CONTENT),
         (5, 44100, 16, 2, 3 * 4096 + 321, BURSTS),
         (5, 48000, 24, 6, 4096 + 33, CONTENT)]


@pytest.mark.parametrize("level, rate, bps, channels, n, content", CASES)
def test_port_streams_read_back(level, rate, bps, channels, n, content):
    pcm = traffic.make_buffer(SEED, 0, n, channels, bps, rate, "cpu",
                              content)
    stream = encode(pcm, level, rate, bps)
    assert check(stream, pcm, rate, bps) == dict.fromkeys(
        ("bad_frames", "bad_samples", "md5_bad", "info_bad"), 0)


@pytest.mark.parametrize("level, rate, bps, channels, n",
                         [c[:5] for c in CASES[:2]])
def test_one_flipped_bit_fails(level, rate, bps, channels, n):
    pcm = traffic.make_buffer(SEED, 1, n, channels, bps, rate, "cpu",
                              CONTENT)
    stream = encode(pcm, level, rate, bps)
    rng = np.random.default_rng(7)
    for _ in range(8):
        s = bytearray(stream)
        i = int(rng.integers(4200, len(s)))
        s[i] ^= 1 << int(rng.integers(0, 8))
        got = check(bytes(s), pcm, rate, bps)
        assert got["bad_frames"] + got["bad_samples"] > 0


def test_changed_input_dropped_frame_and_header_fail():
    pcm = traffic.make_buffer(SEED, 2, 3 * 4096 + 100, 2, 16, 44100, "cpu",
                              CONTENT)
    stream = encode(pcm, 5, 44100, 16)
    other = pcm.copy()
    other[1, 5000] += 1
    got = check(stream, other, 44100, 16)
    assert got["bad_samples"] > 0 and got["md5_bad"] == 1
    # the second frame cut out of the stream
    r = reference.check_stream(stream, pcm, bps=16, rate=44100,
                               blocksize=4096)
    lens = r["parse"]["byte_len"]
    first = len(stream) - int(lens.sum())
    cut = stream[:first + lens[0]] + stream[first + lens[0] + lens[1]:]
    assert check(cut, pcm, 44100, 16)["bad_frames"] > 0
    # a wrong MD5 in STREAMINFO
    s = bytearray(stream)
    s[8 + 18] ^= 1
    assert check(bytes(s), pcm, 44100, 16)["md5_bad"] == 1
