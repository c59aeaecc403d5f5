"""Kernel K1 (csrc/pack_fields64.cu) against its plain PyTorch version, on
a CUDA GPU.

Every test here carries the `gpu` marker and skips without a GPU; the
kernel has no CPU mode (its plain version is held against flac_tpu in
test_torch_bitpack.py).  The file imports neither JAX nor flac_tpu, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_pack_cuda.py -m gpu
"""

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, ref_decoder, signals
from flac_tpu_torch.encoder import StreamEncoder
from flac_tpu_torch.ops import bitpack, pack_cuda, pack_synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K1 has no CPU mode)")
    return torch.device("cuda")


def cases():
    """Random fields, 63-bit fields, three-word straddles, fields past W,
    negative positions, many tiny fields, a frame wider than one CTA's
    tile, and the cluster cases."""
    rng = np.random.default_rng(1)
    out = []
    pb = rng.integers(0, 61, (8, 640)).astype(np.int32)
    pb[rng.random((8, 640)) < 0.08] = 0
    pay = rng.integers(0, 1 << 62, (8, 640), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    out.append(("random", rng.integers(0, 4, (8, 640)).astype(np.int32),
                pay, pb, 2048))
    pb = np.full((4, 500), 63, np.int32)
    pay = rng.integers(0, 1 << 63, (4, 500), dtype=np.int64)
    out.append(("63-bit", rng.integers(0, 3, (4, 500)).astype(np.int32),
                pay, pb, 2048))
    nz = rng.integers(1, 32, (4, 300)).astype(np.int32)
    pb = rng.integers(58, 64, (4, 300)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (4, 300), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    out.append(("straddle", nz, pay, pb, 1024))
    pb = np.full((2, 100), 40, np.int32)
    pay = rng.integers(0, 1 << 40, (2, 100), dtype=np.int64)
    out.append(("past-W", np.zeros((2, 100), np.int32), pay, pb, 64))
    nz = np.zeros((2, 40), np.int32)
    nz[:, 0] = -200
    pb = np.full((2, 40), 20, np.int32)
    pay = rng.integers(0, 1 << 20, (2, 40), dtype=np.int64)
    out.append(("negative", nz, pay, pb, 64))
    pb = rng.integers(1, 5, (8, 1024)).astype(np.int32)
    pay = rng.integers(0, 16, (8, 1024)).astype(np.int64) & ((1 << pb) - 1)
    out.append(("dense", np.zeros((8, 1024), np.int32), pay, pb, 1024))
    # a frame wider than one 16384-word shared-memory tile
    pb = rng.integers(20, 64, (2, 15000)).astype(np.int32)   # ~19.5k words
    pay = rng.integers(0, 1 << 62, (2, 15000), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    out.append(("two-tiles", np.zeros((2, 15000), np.int32), pay, pb,
                32768))
    return out + pack_synth.cluster_cases()


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_k1_matches_plain(case, cuda):
    _, nz, pay, pb, W = case
    args = [torch.from_numpy(a).to(cuda) for a in (nz, pay, pb)]
    before = pack_cuda.launches
    kw, kt = pack_cuda.pack_fields64(*args, W)
    pw, pt = bitpack.pack_fields64(*args, W)
    torch.cuda.synchronize()
    assert pack_cuda.launches == before + 1
    assert kw.dtype == pw.dtype and kt.dtype == pt.dtype
    assert torch.equal(kw, pw) and torch.equal(kt, pt)


def test_encode_kernel_equals_plain_packer(cuda):
    """A -5 encode on the GPU through K1 and through the plain packer: the
    same bytes, and they decode back to the input with the MD5."""
    pcm = signals.make_test_signal(3 * 44100, seed=11)
    streams = []
    for packer in ("kernel", "plain"):
        buf = io.BytesIO()
        enc = StreamEncoder(buf, EncoderConfig.from_preset(5), device=cuda,
                            packer=packer)
        enc.process(pcm)
        enc.finish()
        streams.append(buf.getvalue())
    assert streams[0] == streams[1]
    st = ref_decoder.decode_stream(streams[0], verify_md5=True)
    np.testing.assert_array_equal(st.samples, pcm)
