"""The command line and the 33-bit side channel on a CUDA GPU: the `flac`
tool's encode launches K1 once a quad-layout batch and writes
StreamEncoder's bytes, its decode, -t and -V run K2 and K3, a FLAC input
decodes on the card, and a 32-bit stereo stream (the 33-bit side channel,
safe layout: no K1) decodes through the "device" and "fast" engines.  The
kernels' launch counters show the paths.

Every test here carries the `gpu` marker and skips without a GPU (the CPU
side of these paths is held against flac_tpu in test_torch_cli.py and
test_torch_hires.py).  The file imports neither JAX nor flac_tpu, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_cli_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, cli, container, signals
from flac_tpu_torch import decode_stream_tpu
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ops import pack_cuda, restore_cuda, rice_cuda

pytestmark = pytest.mark.gpu

RATE = 44100
PCM16 = signals.make_test_signal(4096 * 9 + 17, seed=9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K1, K2 and K3 have no CPU mode)")
    return torch.device("cuda")


def _counts():
    return pack_cuda.launches, rice_cuda.launches, restore_cuda.launches


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _library(pcm, rate, bps, device):
    """StreamEncoder with what the tool gives it at -5: the preset's
    blocksize, 4096 bytes of padding and a seek point every 10 s."""
    table = md.SeekTableBlock(points=md.SeekTableBlock.template_spaced(
        pcm.shape[1], rate, 10.0).points)
    return encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, sample_rate=rate, channels=2, bits_per_sample=bps),
        padding=4096, seektable=table, device=device)


def _antiphase(pcm, n):
    """R = -L over the first n samples: a constant mid and a side of up
    to 3.2e9, which takes 33 bits."""
    left = np.round(1.6e9 * np.sin(np.arange(n) * 0.01)).astype(np.int64)
    pcm[0, :n], pcm[1, :n] = left, -left
    return pcm


@pytest.fixture
def wav16(tmp_path):
    path = tmp_path / "t.wav"
    path.write_bytes(container.write_wav(PCM16, RATE, 16))
    return path


def test_encode_launches_k1_and_matches_the_library(cuda, wav16, tmp_path):
    out = tmp_path / "t.flac"
    before = _counts()
    assert cli.main(["-5", "-s", "-o", str(out), str(wav16)]) == 0
    # one quad-layout batch of the 9 full blocks, then the 17-sample tail
    # at finish, which the quad layout cannot take
    assert _delta(before) == (1, 0, 0)
    assert out.read_bytes() == _library(PCM16, RATE, 16, "cuda")


def test_decode_test_and_verify_run_k2_and_k3(cuda, wav16, tmp_path):
    flac = tmp_path / "t.flac"
    assert cli.main(["-5", "-s", "-o", str(flac), str(wav16)]) == 0
    back = tmp_path / "b.wav"
    before = _counts()
    assert cli.main(["-d", "-s", "-o", str(back), str(flac)]) == 0
    k1, k2, k3 = _delta(before)
    assert k1 == 0 and k2 == k3 == 2      # 4096-sample and 17-sample groups
    assert back.read_bytes() == wav16.read_bytes()
    before = _counts()
    assert cli.main(["-t", "-s", str(flac)]) == 0
    assert _delta(before)[1:] == (2, 2)
    verified = tmp_path / "v.flac"
    before = _counts()
    assert cli.main(["-5", "-s", "-V", "-o", str(verified), str(wav16)]) == 0
    assert _delta(before) == (1, 2, 2)    # verify decodes each written batch
    assert verified.read_bytes() == flac.read_bytes()


def test_flac_input_decodes_on_the_card(cuda, wav16, tmp_path):
    flac = tmp_path / "t.flac"
    assert cli.main(["-5", "-s", "-T", "TITLE=x", "-o", str(flac),
                     str(wav16)]) == 0
    again = tmp_path / "t8.flac"
    before = _counts()
    assert cli.main(["-8", "-s", "-o", str(again), str(flac)]) == 0
    k1, k2, k3 = _delta(before)
    assert k1 > 0 and k2 > 0 and k3 > 0
    st = decode_stream_tpu(again.read_bytes())
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, PCM16)
    assert md.get_tags(str(again)).get("TITLE") == ["x"]


def test_33bit_side_on_the_card(cuda, tmp_path):
    pcm = _antiphase(signals.make_hires32_signal(4096 * 6), 4096 * 2)
    wav = tmp_path / "hi.wav"
    wav.write_bytes(container.write_wav(pcm, 96000, 32))
    flac = tmp_path / "hi.flac"
    before = _counts()
    assert cli.main(["-5", "-s", "-o", str(flac), str(wav)]) == 0
    assert _delta(before)[0] == 0         # the safe layout: no K1
    data = flac.read_bytes()
    cpu = _library(pcm, 96000, 32, "cpu")
    assert abs(len(data) - len(cpu)) <= 0.001 * len(cpu)
    host = decode_stream_tpu(data, engine="host")
    assignments = {f["assignment"] for f in host.frames}
    assert assignments - {0}, "no frame chose a side channel"
    for engine in ("device", "fast"):
        before = _counts()
        st = decode_stream_tpu(data, engine=engine)
        k1, k2, k3 = _delta(before)
        assert k3 > 0 and (k2 > 0) == (engine == "device")
        assert st.md5_ok
        np.testing.assert_array_equal(st.samples, pcm)
        np.testing.assert_array_equal(st.samples, host.samples)
