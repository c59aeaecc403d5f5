"""Kernel K2 (csrc/rice_codes.cu) and its probe P2 against the plain
PyTorch version, on a CUDA GPU.

Every test here carries the `gpu` marker and skips without a GPU; the
kernel has no CPU mode (its plain version is held against flac_tpu in
test_torch_bitunpack.py).  The file imports neither JAX nor flac_tpu, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_rice_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, decode_stream_tpu, signals
from flac_tpu_torch import decoder_device as dd
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ops import bitunpack, rice_cuda, rice_synth
from flac_tpu_torch.ref_decoder import parse_metadata

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K2 has no CPU mode)")
    return torch.device("cuda")


def _same(args, kw):
    before = rice_cuda.launches
    kres, kovf = rice_cuda.rice_codes(*args, **kw)
    pres, povf = bitunpack.rice_codes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert rice_cuda.launches == before + 1
    assert kres.dtype == pres.dtype and kovf.dtype == povf.dtype
    assert torch.equal(kovf, povf)
    ok = ~povf
    assert torch.equal(kres[:, ok], pres[:, ok])
    return povf


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("lanes", [None, 1000], ids=["cases", "1000"])
def test_k2_matches_plain_synthetic(cuda, wide, lanes):
    words2d, lane_start, segs = rice_synth.synthetic_lanes(
        3, wide=wide, lanes=lanes)
    args = [torch.from_numpy(a).to(cuda) for a in (words2d, lane_start,
                                                   segs)]
    ovf = _same(args, dict(T=rice_synth.T, NROW=rice_synth.NROW,
                           SEG=rice_synth.SEG, wide=wide))
    assert ovf.any()


@pytest.mark.parametrize("preset", [5, 8])
def test_k2_matches_plain_on_a_stream(cuda, preset):
    pcm = signals.make_test_signal(4096 * 20 + 999, seed=preset)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(preset),
                               device=cuda)
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    arr = np.frombuffer(data, np.uint8)
    for wide in (False, True):
        prep = dd._prep_batch(arr, frames, list(range(20)), 4096, 2)
        arrays, kw = dd.batch_inputs(arr, *prep)
        args = [torch.from_numpy(a).to(cuda) for a in arrays[:3]]
        _same(args, dict(T=128, NROW=kw["NROW"], SEG=kw["SEG"], wide=wide))


def test_p2_probe(cuda):
    rice_cuda.probe()


def test_decode_on_the_gpu(cuda):
    pcm = signals.make_test_signal(4096 * 9 + 17, seed=9)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(5),
                               device=cuda)
    before = rice_cuda.launches
    st = decode_stream_tpu(data, max_batch=4)
    assert rice_cuda.launches - before == 4      # 4 + 4 + 1 frames, tail
    np.testing.assert_array_equal(st.samples, pcm)
    assert st.md5_ok
