"""The whole slice at preset -8 on 24-bit stereo, whose side channel
needs 25 bits: flac_tpu_torch's stream decodes bit-exact, with the
STREAMINFO MD5, through flac_tpu's reference decoder, comes within 0.1%
of flac_tpu's size, and is byte-identical on this corpus (see
`assert_round_trip_and_size` in test_torch_corpus.py).
"""

import pytest

from test_torch_corpus import assert_round_trip_and_size


@pytest.mark.parametrize("level,kind", [(8, "hires")])
def test_stream_round_trip_and_size(level, kind):
    assert_round_trip_and_size(level, kind)
