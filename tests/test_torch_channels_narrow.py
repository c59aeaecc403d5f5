"""16-bit mono (spoken word) and 8-bit stereo in flac_tpu_torch against
flac_tpu, on the CPU: byte-identical at -0, within 0.1% of flac_tpu's
size at -5, every stream decoded with its MD5 by flac_tpu's reference
decoder and the port's three engines.  The layouts and helpers are
test_torch_channels.py's.
"""

import pytest
import torch

from test_torch_channels import assert_identical_at_preset_0, \
    assert_size_at_preset_5

torch.set_num_threads(1)

LABELS = ['mono, 16-bit', 'stereo, 8-bit']


@pytest.mark.parametrize("label", LABELS)
def test_byte_identical_at_preset_0(label):
    assert_identical_at_preset_0(label)


@pytest.mark.parametrize("label", LABELS)
def test_size_at_preset_5(label):
    assert_size_at_preset_5(label)
