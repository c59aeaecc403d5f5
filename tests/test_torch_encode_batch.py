"""flac_tpu_torch's encode_batch against flac_tpu's on the CPU: one batch
of frames through both packages, packed the same, in both layouts.  A
file of its own, apart from test_torch_frame.py, so that `--dist
loadfile` runs flac_tpu's encode_batch compiles on another worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flac_tpu import encoder as jenc
from flac_tpu_torch import encoder as tenc

from test_torch_frame import N, T, blocks, configs, same


@pytest.mark.parametrize("level", [8])
def test_encode_batch(level):
    """One batch through both packages' encode_batch: the same packed
    frames (the per-frame number array of the safe re-encode included)."""
    jcfg, tcfg = configs(level)
    pcm = blocks("music", B=3, seed=10 + level)
    nums = np.array([7, 2, 300], np.int64) - np.arange(3)
    jp = jenc.encode_batch(jnp.asarray(pcm), jnp.asarray(nums), jcfg, N,
                           layout="safe")
    tp = tenc.encode_batch(T(pcm), T(nums), tcfg, N, layout="safe")
    for name in ("words", "byte_len", "ok"):
        same(jp.words if name == "words" else getattr(jp, name),
             getattr(tp, name), name)
    jq = jenc.encode_batch(jnp.asarray(pcm), np.int64(5), jcfg, N)
    tq = tenc.encode_batch(T(pcm), 5, tcfg, N)
    same(jq.words, tq.words)
    same(jq.byte_len, tq.byte_len)


def test_encode_batch_limit_min_bitrate():
    """limit_min_bitrate turns the last subframe of an all-constant frame
    verbatim; both packages' encode_batch pack the same frames."""
    jcfg, tcfg = configs(0, limit_min_bitrate=True)
    pcm = blocks("silence", B=3)
    jq = jenc.encode_batch(jnp.asarray(pcm), np.int64(4), jcfg, N)
    tq = tenc.encode_batch(T(pcm), 4, tcfg, N)
    same(jq.words, tq.words)
    same(jq.byte_len, tq.byte_len)
