"""24-bit 96 kHz stereo at -5 and -8 in flac_tpu_torch against flac_tpu,
on the CPU: within 0.1% of flac_tpu's size (LPC, whose float analysis may
round otherwise), and every stream decodes with its MD5 through flac_tpu's
reference decoder and the port's "host", "device" and "fast" engines.
The case and its helpers are test_torch_hires24.py's (-0 to -2 there).
"""

import pytest
import torch

from test_torch_hires24 import RATE, assert_decodes, encode_both, music

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [5, 8])
def test_size_at_lpc_presets(level):
    pcm = music()
    ours, ref = encode_both(pcm, level, 24, RATE)
    assert abs(len(ours) - len(ref)) <= 0.001 * len(ref), (len(ours),
                                                           len(ref))
    assert_decodes(ours, pcm)
