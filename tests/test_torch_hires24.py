"""24-bit 96 kHz stereo (BASELINE.json config 3, hi-res masters) in
flac_tpu_torch against flac_tpu, on the CPU.

The streams come from the port's signal recipe
(`signals.make_test_signal(n, 2, 24, seed=...)`), the one chip_smoke.py
encodes on the card.  At -0, -1 and -2 the port's streams are
byte-identical to flac_tpu's; at -5 and -8 (LPC, whose float analysis
may round otherwise) their size is within 0.1% of flac_tpu's.  Every
stream decodes with its MD5 through flac_tpu's reference decoder and the
port's "host", "device" and "fast" engines (the plain versions of K2 and
K3).  At 24 bits the Rice parameters take the RICE2 range, the LPC
residuals of most candidates the exact "f64" mode, and K3's output int32.

Every encode runs two frames a batch at blocksize 1152, two frames long,
so flac_tpu compiles one batch shape for each preset (and, as every
24-bit frame misfits the quad layout, its safe re-encode).  The presets
with LPC, -5 and -8, are in test_torch_hires24_lpc.py, so that each file
stays about a minute on one worker; both use the helpers here.
"""

import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as RefConfig
from flac_tpu.encoder import encode_file_to_flac as ref_encode
from flac_tpu.ref_decoder import decode_stream as ref_decode
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, signals
from flac_tpu_torch.encoder import encode_file_to_flac

torch.set_num_threads(1)

N = 1152
FRAMES = 2
RATE = 96000


def _cfg(pkg, level, channels=2, bps=24, rate=RATE):
    return pkg.from_preset(level, sample_rate=rate, channels=channels,
                           bits_per_sample=bps, blocksize=N)


def encode_both(pcm, level, bps, rate):
    """(the port's stream on the CPU, flac_tpu's stream) of pcm [C, n]."""
    C = pcm.shape[0]
    ours = encode_file_to_flac(pcm, _cfg(EncoderConfig, level, C, bps, rate),
                               batch_frames=FRAMES, device="cpu")
    ref = ref_encode(pcm, _cfg(RefConfig, level, C, bps, rate),
                     batch_frames=FRAMES)
    return ours, ref


def assert_decodes(stream, pcm):
    """The stream gives pcm back with its MD5 through flac_tpu's reference
    decoder and the port's host, device and fast engines."""
    ref = ref_decode(stream)                # raises on an MD5 mismatch
    np.testing.assert_array_equal(ref.samples, pcm)
    for engine in ("host", "device", "fast"):
        st = decode_stream_tpu(stream, engine=engine, device="cpu")
        assert st.md5_ok, engine
        np.testing.assert_array_equal(st.samples, pcm, err_msg=engine)


def music():
    """Two frames of 24-bit stereo of the port's signal recipe."""
    return signals.make_test_signal(N * FRAMES, 2, 24, seed=96)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_byte_identical_at_fast_presets(level):
    pcm = music()
    ours, ref = encode_both(pcm, level, 24, RATE)
    assert ours == ref
    assert_decodes(ours, pcm)


@pytest.mark.parametrize("blocksize", [N, 4096])
def test_config_takes_the_wide_paths(blocksize):
    """What sets the 24-bit stream apart from the 16-bit main path,
    resolved as flac_tpu resolves it: the RICE2 escape code 31 (Rice
    parameters up to 30), the precision limit (15 at blocksize 4096, 14
    at 1152) and a 25-bit side."""
    ours = EncoderConfig.from_preset(8, sample_rate=RATE, bits_per_sample=24,
                                     blocksize=blocksize).resolve()
    ref = RefConfig.from_preset(8, sample_rate=RATE, bits_per_sample=24,
                                blocksize=blocksize).resolve()
    assert (ours.rice_param_limit, ours.qlp_coeff_precision,
            ours.max_subframe_bps) == (ref.rice_param_limit,
                                       ref.qlp_coeff_precision,
                                       ref.max_subframe_bps)
    assert ours.rice_param_limit == 31 and ours.max_subframe_bps == 25
    assert ours.qlp_coeff_precision == (15 if blocksize == 4096 else 14)
