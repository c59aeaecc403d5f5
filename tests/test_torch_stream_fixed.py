"""The whole slice at preset -0 (and 24-bit at -1): flac_tpu_torch's
streams are byte-identical to flac_tpu's on the CPU.

These presets have no LPC (max_lpc_order 0), so no float analysis decides
anything: every stage is integer and the two packages must write the same
bytes, STREAMINFO (MD5, frame sizes) included, on the corpus of
test_torch_corpus.py.  Presets -1 and -2 are in test_torch_stream_fixed12.py,
a file of their own so that `--dist loadfile` runs the two halves on two
workers.
"""

import numpy as np
import pytest

from flac_tpu import ref_decoder as jref

from test_torch_corpus import assert_byte_identical, corpus, encode_port


CASES = [(0, kind) for kind in ("music", "silence", "burst")] + [
    (1, "hires")]


@pytest.mark.parametrize("level,kind", CASES)
def test_stream_byte_identical(level, kind):
    assert_byte_identical(level, kind)


def test_limit_min_bitrate_silence():
    """limit_min_bitrate turns the last subframe of an all-constant frame
    verbatim, and the stream decodes with the MD5.  The frames are held
    against flac_tpu's in test_torch_encode_batch.py
    (test_encode_batch_limit_min_bitrate), which costs flac_tpu far less
    compiling than a stream."""
    pcm = corpus("silence")
    port, _ = encode_port(pcm, 0, limit_min_bitrate=True)
    st = jref.decode_stream(port, verify_md5=True)
    np.testing.assert_array_equal(st.samples, pcm)
    types = {s["type"] for f in st.frames for s in f["subframes"]}
    assert types >= {"CONSTANT", "VERBATIM"}
