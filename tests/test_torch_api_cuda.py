"""The library API's device paths on a CUDA GPU: verify=True decodes every
written super-chunk or batch through K2 and K3, FlacReader reads through them, and so
does the Ogg decode; the kernels' launch counters show it.

Every test here carries the `gpu` marker and skips without a GPU (the
CPU side of these paths is held against flac_tpu in
test_torch_encoder_api.py, test_torch_seek.py and test_torch_ogg.py).  The
file imports neither JAX nor flac_tpu, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_api_cuda.py -m gpu
"""

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, ogg, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch import metadata as md
from flac_tpu_torch.decoder import decode_stream_auto
from flac_tpu_torch.encoder import StreamEncoder
from flac_tpu_torch.ops import restore_cuda, rice_cuda
from flac_tpu_torch.seek import FlacReader

pytestmark = pytest.mark.gpu

N = 4096
PCM = signals.make_test_signal(N * 9 + 17, seed=9)
UNITS = 3     # written: a super-chunk of 8 frames, a batch of 1, the tail


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K2 and K3 have no CPU mode)")
    return torch.device("cuda")


def _encode(pcm, verify, **kw):
    buf = io.BytesIO()
    calls = []
    with StreamEncoder(buf, EncoderConfig.from_preset(5, blocksize=N),
                       batch_frames=4, verify=verify,
                       progress_callback=lambda *a: calls.append(a),
                       **kw) as enc:
        enc.process(pcm)
        enc.finish()
    return buf.getvalue(), calls


def _counts():
    return rice_cuda.launches, restore_cuda.launches


def test_verify_runs_k2_and_k3_once_a_batch(cuda):
    """verify=True leaves the bytes as verify=False writes them, and
    launches K2 and K3 once for each written super-chunk or batch."""
    def table():
        return md.SeekTableBlock.template_spaced(PCM.shape[1], 44100, 0.2)
    plain, _ = _encode(PCM, False, seektable=table())
    k2, k3 = _counts()
    verified, calls = _encode(PCM, True, seektable=table())
    assert (rice_cuda.launches - k2, restore_cuda.launches - k3) == (
        UNITS, UNITS)
    assert [c[0] for c in calls] == [8, 9, 10]
    assert verified == plain
    st = decode_stream_auto(verified)
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, PCM)


def test_verify_catches_a_bit_flipped_on_the_card(cuda, monkeypatch):
    real = encoder_mod.encode_batch

    def corrupted(*a, **k):
        pf = real(*a, **k)
        words = pf.words.clone()
        words[0, 9] ^= 1 << 7
        return pf._replace(words=words)
    monkeypatch.setattr(encoder_mod, "encode_batch", corrupted)
    buf = io.BytesIO()
    with pytest.raises(RuntimeError, match="stream NOT written"):
        with StreamEncoder(buf, EncoderConfig.from_preset(5, blocksize=N),
                           batch_frames=4, verify=True) as enc:
            enc.process(PCM)
            enc.finish()
    assert len(buf.getvalue()) == enc._first_frame_offset


@pytest.mark.parametrize("table", [False, True])
def test_reader_reads_through_k2_and_k3(cuda, table):
    seek = md.SeekTableBlock.template_spaced(PCM.shape[1], 44100, 0.1) \
        if table else None
    data, _ = _encode(PCM, False, seektable=seek)
    rd = FlacReader(data)
    assert rd.device.type == "cuda"
    rng = np.random.default_rng(table)
    for _ in range(6):
        start = int(rng.integers(0, N * 8 - 3000))
        k2, k3 = _counts()
        got = rd.read_range(start, 3000)
        assert _counts() == (k2 + 1, k3 + 1)
        np.testing.assert_array_equal(got, PCM[:, start:start + 3000])


def test_ogg_decode_on_the_card(cuda):
    data, _ = _encode(PCM, False)
    out = io.BytesIO()
    ogg.wrap_flac_stream(data, out)
    k2, k3 = _counts()
    st = decode_stream_auto(out.getvalue())
    assert rice_cuda.launches > k2 and restore_cuda.launches > k3
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, PCM)
    mid = ogg.decode_ogg_flac_range(out.getvalue(), 5000, 20000)
    np.testing.assert_array_equal(mid.samples, PCM[:, 5000:25000])
