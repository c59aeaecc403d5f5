"""Mono, 8-bit stereo and three to eight channels in flac_tpu_torch
against flac_tpu, on the CPU.

Streams of the port's signal recipe (`signals.make_test_signal(n, C,
bps, seed=...)`): 3, 6 and 8 channels of 16 bits, 6 channels of 24 bits
(5.1 film and surround archives), 16-bit mono (spoken word) and 8-bit
stereo.  Past two channels, and on one, there is no mid-side search: the
channels pass through K10 one CTA a (frame, channel) and K12 does not
launch.  At -0 the port's streams are byte-identical to flac_tpu's, at
-5 within 0.1% of their size; every stream decodes with its MD5 through
flac_tpu's reference decoder and the port's "host", "device" and "fast"
engines (the plain versions of K2 and K3).

Every encode runs two frames a batch at blocksize 1152, two frames long,
so flac_tpu compiles one batch shape for each preset.  This file takes
the 16-bit multichannel layouts; test_torch_channels24.py takes 5.1 of
24 bits and test_torch_channels_narrow.py mono and 8-bit stereo, with the
helpers here, so that each file stays about a minute on one worker.
"""

import pytest
import torch

from test_torch_hires24 import FRAMES, N, assert_decodes, encode_both

from flac_tpu_torch import signals

torch.set_num_threads(1)

# label -> (channels, bits per sample, sample rate)
LAYOUTS = {
    "3 channels, 16-bit": (3, 16, 48000),
    "5.1, 16-bit": (6, 16, 48000),
    "7.1, 16-bit": (8, 16, 48000),
    "5.1, 24-bit": (6, 24, 48000),
    "mono, 16-bit": (1, 16, 44100),
    "stereo, 8-bit": (2, 8, 44100),
}


def _signal(label):
    C, bps, _ = LAYOUTS[label]
    return signals.make_test_signal(N * FRAMES, C, bps,
                                    seed=list(LAYOUTS).index(label))


def assert_identical_at_preset_0(label):
    """The port's -0 stream of the layout is flac_tpu's, byte for byte,
    and decodes back."""
    pcm = _signal(label)
    _, bps, rate = LAYOUTS[label]
    ours, ref = encode_both(pcm, 0, bps, rate)
    assert ours == ref
    assert_decodes(ours, pcm)


def assert_size_at_preset_5(label):
    """The port's -5 stream of the layout is within 0.1% of flac_tpu's
    size, and decodes back."""
    pcm = _signal(label)
    _, bps, rate = LAYOUTS[label]
    ours, ref = encode_both(pcm, 5, bps, rate)
    assert abs(len(ours) - len(ref)) <= 0.001 * len(ref), (len(ours),
                                                           len(ref))
    assert_decodes(ours, pcm)


MULTICHANNEL_16 = ["3 channels, 16-bit", "5.1, 16-bit", "7.1, 16-bit"]


@pytest.mark.parametrize("label", MULTICHANNEL_16)
def test_byte_identical_at_preset_0(label):
    assert_identical_at_preset_0(label)


@pytest.mark.parametrize("label", MULTICHANNEL_16)
def test_size_at_preset_5(label):
    assert_size_at_preset_5(label)
