"""The whole slice at preset -8 on 16-bit stereo: flac_tpu_torch's
streams decode bit-exact, with the STREAMINFO MD5, through flac_tpu's
reference decoder, come within 0.1% of flac_tpu's size, and are
byte-identical on this corpus (see `assert_round_trip_and_size` in
test_torch_corpus.py).  24-bit at -8 is in test_torch_stream_hires8.py, a
file of its own so that `--dist loadfile` runs it on another worker.
"""

import pytest

from test_torch_corpus import assert_round_trip_and_size


@pytest.mark.parametrize("level,kind", [(8, kind) for kind in
                                        ("music", "silence", "burst")])
def test_stream_round_trip_and_size(level, kind):
    assert_round_trip_and_size(level, kind)
