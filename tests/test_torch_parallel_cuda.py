"""The parallel paths and the encoder's pipeline on a CUDA GPU: sharded
encode over mesh entries that repeat the card (K1 once an entry), the
sharded decode (K3 once an entry) and the pipelined StreamEncoder's pinned
copies, whose bytes do not depend on its options.

Every test here carries the `gpu` marker and skips without a GPU (the CPU
side is held against flac_tpu in test_torch_shard.py,
test_torch_multihost.py and test_torch_encoder_pipeline.py).  The file
imports neither JAX nor flac_tpu:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_parallel_cuda.py -m gpu
"""

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.encoder import StreamEncoder, _HostCopy
from flac_tpu_torch.ops import pack_cuda, restore_cuda
from flac_tpu_torch.parallel.shard import (data_mesh, decode_frames_dp,
                                           encode_blocks_dp)
from flac_tpu_torch.ref_decoder import parse_metadata

pytestmark = pytest.mark.gpu

N = 4096
FRAMES = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K1 and K3 have no CPU mode)")
    return torch.device("cuda")


def _pcm(frames, seed=31):
    return signals.make_test_signal(N * frames, seed=seed)


def test_sharded_encode_launches_k1_once_an_entry(cuda):
    pcm = _pcm(FRAMES)
    blocks = pcm.reshape(2, FRAMES, N).transpose(1, 0, 2)
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    w1, l1 = encode_blocks_dp(blocks, 0, cfg, data_mesh())
    before = pack_cuda.launches
    w2, l2 = encode_blocks_dp(blocks, 0, cfg, data_mesh([cuda] * 2))
    assert pack_cuda.launches - before == 2
    np.testing.assert_array_equal(l1, l2)
    for i in range(FRAMES):
        k = (int(l1[i]) + 3) // 4
        np.testing.assert_array_equal(w1[i, :k], w2[i, :k])


def test_sharded_decode_launches_k3_once_an_entry(cuda):
    pcm = _pcm(FRAMES)
    buf = io.BytesIO()
    with StreamEncoder(buf, EncoderConfig.from_preset(5, blocksize=N),
                       batch_frames=8) as enc:
        enc.process(pcm)
        enc.finish()
    data = buf.getvalue()
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    for entries in (1, 3):
        before = restore_cuda.launches
        out = decode_frames_dp(data, st, frames, data_mesh([cuda] * entries))
        assert restore_cuda.launches - before == entries
        np.testing.assert_array_equal(out, pcm)


def test_host_copy_is_pinned_and_waits(cuda):
    t = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    copy = _HostCopy(t)
    assert copy.host.is_pinned()
    np.testing.assert_array_equal(copy.wait(), np.arange(1 << 20))
    assert copy.done()


def test_pipeline_bytes_do_not_depend_on_the_options(cuda):
    """The pipelined encoder's pinned copies and events: the same stream
    at (pipeline_depth, super_batches) = (1, 1), (2, 3) and the default."""
    pcm = _pcm(40, seed=32)[:, :N * 40 - 123]
    streams = []
    for kw in ({"pipeline_depth": 1, "super_batches": 1},
               {"pipeline_depth": 2, "super_batches": 3}, {}):
        buf = io.BytesIO()
        with StreamEncoder(buf, EncoderConfig.from_preset(5, blocksize=N),
                           batch_frames=4, **kw) as enc:
            enc.process(pcm)
            enc.finish()
        streams.append(buf.getvalue())
    assert streams[0] == streams[1] == streams[2]
