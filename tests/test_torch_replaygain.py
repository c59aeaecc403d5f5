"""flac_tpu_torch.replaygain against flac_tpu.replaygain, on the CPU.

The analysis runs its filter cascade through the port's native runtime
(`native.iir_filter`, the verbatim `ft_iir`); flac_tpu runs the same
function through its own build.  Gains and peaks must be bit-identical
(==, not close) at every table rate and at rates that halve down to one,
over chunked feeds and album boundaries; so must the tags, the gain
synthesis with its limiter and noise-shaped dither, and the filter
itself.  Nothing here compiles.
"""

import numpy as np
import pytest
import torch

from flac_tpu import native as jnative
from flac_tpu import replaygain as jrg
from flac_tpu_torch import native
from flac_tpu_torch import replaygain as rg

torch.set_num_threads(1)

TABLE_RATES = sorted(rg._FILTERS)
RATES = TABLE_RATES + [r * 2 for r in TABLE_RATES] + [176400, 192000,
                                                      384000]


def _tone(rate, n, seed, bps=16):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    amp = 0.25 * (1 << (bps - 1))
    sig = amp * np.sin(2 * np.pi * 440 * t) + rng.normal(0, amp / 8, n)
    return np.stack([sig, 0.7 * sig]).astype(np.int32)


def _analyze(mod, rate, tracks, bps, chunks):
    an = mod.GainAnalyzer(rate)
    out = []
    for pcm in tracks:
        pos = 0
        for sz in chunks:
            an.analyze_pcm(pcm[:, pos:pos + sz], bps)
            pos += sz
        an.analyze_pcm(pcm[:, pos:], bps)
        out.append((an.title_gain(), an.track_peak))
        an.next_track()
    return out + [(an.album_gain(), an.album_peak)]


def test_valid_rates_match():
    for rate in RATES + [44101, 7999, 1, 96001]:
        assert rg.valid_sample_rate(rate) == jrg.valid_sample_rate(rate)
        assert rg._resolve_rate(rate) == jrg._resolve_rate(rate)
    assert all(rg.valid_sample_rate(r) for r in RATES)
    with pytest.raises(ValueError):
        rg.GainAnalyzer(44101)


@pytest.mark.parametrize("rate", RATES)
def test_gains_and_peaks_are_bit_identical(rate):
    n = rate * 3 // 10                  # 0.3 s: six 50 ms windows
    tracks = [_tone(rate, n, seed=1), _tone(rate, n // 2, seed=2) // 3]
    chunks = [1, 7, 999, n // 3]
    got = _analyze(rg, rate, tracks, 16, chunks)
    assert got == _analyze(jrg, rate, tracks, 16, chunks)
    assert all(g is not None for g, _ in got)


@pytest.mark.parametrize("bps", [8, 12, 20, 24, 32])
def test_other_widths_are_bit_identical(bps):
    tracks = [_tone(44100, 44100 // 4, seed=bps, bps=bps)]
    assert _analyze(rg, 44100, tracks, bps, [1000]) == \
        _analyze(jrg, 44100, tracks, bps, [1000])


def test_tags_match():
    args = (-1.484, 0.398803711, 2.0, 0.5)
    assert rg.format_tags(*args) == jrg.format_tags(*args)
    for v in ("-6.54 dB", "+2.00 dB", "junk", "", "3"):
        assert rg.parse_gain_tag(v) == jrg.parse_gain_tag(v)
    comments = [("TITLE", "x"), ("REPLAYGAIN_TRACK_GAIN", "-1 dB"),
                ("replaygain_album_peak", "0.5")]
    assert rg.strip_tags(comments) == jrg.strip_tags(comments)


@pytest.mark.parametrize("shaping", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("target_bps, scale, hard", [
    (16, 0.5, False), (16, 100.0, True), (24, 1.0, False), (8, 3.0, True)])
def test_apply_gain_is_bit_identical(shaping, target_bps, scale, hard):
    pcm = _tone(44100, 3000, seed=3)
    outs = []
    for mod in (rg, jrg):
        dither = None if shaping is None else mod.DitherContext(
            target_bps, shaping)
        outs.append(mod.apply_gain(pcm, 16, target_bps, scale,
                                   hard_limit=hard, dither=dither))
    assert outs[0].dtype == outs[1].dtype
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("which", ["yule", "butter"])
def test_iir_filter_is_bit_identical(which):
    """The filter with its history threaded over chunks (one shorter than
    the order), against flac_tpu.native's binding of the same source."""
    byule, ayule, bbutter, abutter = rg._FILTERS[48000]
    b, a = (byule, ayule) if which == "yule" else (bbutter, abutter)
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    order = len(b) - 1
    x = np.random.default_rng(4).normal(0, 1000, 5000)
    states = [(np.zeros(order), np.zeros(order)) for _ in "ab"]
    pos = 0
    for n in (order - 1, 1, 1000, 3999 - order):
        chunk = x[pos:pos + n]
        pos += n
        outs = []
        for i, mod in enumerate((native, jnative)):
            y, xh, yh = mod.iir_filter(chunk, b, a, *states[i])
            states[i] = (xh, yh)
            outs.append((y, xh, yh))
        for g, w in zip(*outs):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
