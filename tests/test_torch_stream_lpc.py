"""The whole slice at preset -5: flac_tpu_torch's streams decode bit-exact,
with the STREAMINFO MD5, through flac_tpu's reference decoder, come within
0.1% of flac_tpu's size, and are byte-identical on this corpus (see
`assert_round_trip_and_size` in test_torch_corpus.py).
"""

import numpy as np
import pytest

from flac_tpu import ref_decoder as jref

from test_torch_corpus import (assert_round_trip_and_size, corpus,
                               encode_port)


@pytest.mark.parametrize("level,kind", [(5, kind) for kind in
                                        ("music", "silence", "burst",
                                         "mono")])
def test_stream_round_trip_and_size(level, kind):
    assert_round_trip_and_size(level, kind)


def test_escape_coding_round_trip():
    """Escape coding (no preset turns it on) at -5 on the burst signal,
    whose clicks make raw partitions cheaper than Rice: the stream decodes
    bit-exact with the MD5, holds escaped partitions, and is smaller than
    without escape coding.  The escaped choices are held against
    flac_tpu's subframe by subframe in test_torch_frame.py (its escape-coded
    burst case), which costs flac_tpu far less compiling than a stream."""
    pcm = corpus("burst")
    port, _ = encode_port(pcm, 5, do_escape_coding=True)
    st = jref.decode_stream(port, verify_md5=True)
    np.testing.assert_array_equal(st.samples, pcm)
    raw = [p for f in st.frames for sf in f["subframes"]
           for p in sf.get("params", ()) if isinstance(p, tuple)]
    assert raw
    assert len(port) < len(encode_port(pcm, 5)[0])
