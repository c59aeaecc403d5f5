"""The whole slice at presets -1 and -2: flac_tpu_torch's streams are
byte-identical to flac_tpu's on the CPU (see test_torch_stream_fixed.py for
-0 and why these presets must match byte for byte).
"""

import pytest

from test_torch_corpus import assert_byte_identical


CASES = [(level, kind) for level in (1, 2)
         for kind in ("music", "silence", "burst")] + [(2, "mono")]


@pytest.mark.parametrize("level,kind", CASES)
def test_stream_byte_identical(level, kind):
    assert_byte_identical(level, kind)
