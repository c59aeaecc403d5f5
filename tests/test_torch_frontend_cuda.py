"""Kernels K10 (csrc/channel_candidates.cu, the channel candidates), K11
(csrc/window_autoc.cu, the windowed autocorrelation) and K12
(csrc/assign_channels.cu, the channel assignment) against their plain
PyTorch versions (models/stereo.py build_channel_candidates_plain and
loose_assignment, ops/lpc.py autocorrelation_plain, models/stereo.py
assign_channels_plain), on a CUDA GPU:

- every corner of ops/frontend_synth.py: every output bit-identical;
- the inputs of real 64-frame -5 and -8 batches (the ops form's
  arguments, int16 uploads) and of a -4 batch (the loose path): the same;
- a graph replay adds the launches of K10-K12 its graph holds (one each a
  call) and still equals the ops form;
- no host sync in warm calls of the wrappers under
  torch.cuda.set_sync_debug_mode("error");
- a launch the kernel refuses raises.

Every test here carries the `gpu` marker and skips without a GPU (the
plain versions are held against flac_tpu in test_torch_frontend.py).  The
file imports neither JAX nor flac_tpu:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_frontend_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, kernels, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.models import stereo
from flac_tpu_torch.ops import assign_cuda, autoc_cuda, candidates_cuda, \
    frontend_synth
from flac_tpu_torch.ops import lpc as lpc_ops

pytestmark = pytest.mark.gpu

N = 4096
CANDIDATE_CASES = frontend_synth.candidate_cases()
AUTOC_CASES = frontend_synth.autoc_cases()
ASSIGN_CASES = frontend_synth.assign_cases()
# the dispatchers spied on in the ops form: (module, name, key)
SPIED = ((stereo, "build_channel_candidates", "k10"),
         (lpc_ops, "window_autocorrelation", "k11"),
         (stereo, "assign_channels", "k12"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K10-K12 have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("label,case", CANDIDATE_CASES,
                         ids=[c[0] for c in CANDIDATE_CASES])
def test_k10_matches_plain_on_the_corners(cuda, label, case):
    pcm, cfg = frontend_synth.as_candidate_inputs(case, cuda)
    before = candidates_cuda.launches
    got = stereo.build_channel_candidates(pcm, cfg)
    want = stereo.build_channel_candidates_plain(pcm, cfg)
    if candidates_cuda.forms(pcm.shape[1], cfg)[2]:
        want += (stereo.loose_assignment(pcm.int(), cfg)[0],)
    torch.cuda.synchronize()
    assert candidates_cuda.launches == before + 1
    assert _same(got, want)


@pytest.mark.parametrize("label,case", AUTOC_CASES,
                         ids=[c[0] for c in AUTOC_CASES])
def test_k11_matches_plain_on_the_corners(cuda, label, case):
    args = frontend_synth.as_autoc_inputs(case, cuda)
    before = autoc_cuda.launches
    got = lpc_ops.window_autocorrelation(*args)
    want = lpc_ops.autocorrelation_plain(*args)
    torch.cuda.synchronize()
    assert autoc_cuda.launches == before + 1
    assert _same(got, want)


@pytest.mark.parametrize("label,case", ASSIGN_CASES,
                         ids=[c[0] for c in ASSIGN_CASES])
def test_k12_matches_plain_on_the_corners(cuda, label, case):
    choice, x, loose = frontend_synth.as_assign_inputs(case, cuda)
    cfg = EncoderConfig(limit_min_bitrate=case["limit_min_bitrate"])
    before = assign_cuda.launches
    got = stereo.assign_channels(choice, x, loose, cfg, mid_side=True)
    want = stereo.assign_channels_plain(choice, x, loose, cfg)
    torch.cuda.synchronize()
    assert assign_cuda.launches == before + 1
    assert _same(got, want)


def _blocks(level, cuda, frames=64):
    pcm = signals.make_test_signal(frames * N, seed=60 + level)
    return torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, frames, N).transpose(1, 0, 2)).astype(np.int16)
    ).to(cuda)


def _front_inputs(level, cuda):
    """The arguments of build_channel_candidates (k10),
    window_autocorrelation (k11) and assign_channels (k12) in the ops form
    of a 64-frame batch at -level."""
    cfg = EncoderConfig.from_preset(level, blocksize=N).resolve()
    x = _blocks(level, cuda)
    seen = {}
    real = {key: getattr(mod, name) for mod, name, key in SPIED}

    def spy(key):
        def call(*a):
            seen[key] = a
            return real[key](*a)
        return call
    for mod, name, key in SPIED:
        setattr(mod, name, spy(key))
    try:
        encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(0, 64, cuda), cfg, N, "auto",
            "kernel")
    finally:
        for mod, name, key in SPIED:
            setattr(mod, name, real[key])
    return seen


@pytest.mark.parametrize("level", [5, 8, 4])
def test_k10_k11_k12_match_plain_on_a_real_batch(cuda, level):
    seen = _front_inputs(level, cuda)
    pcm, cfg = seen["k10"]
    assert pcm.dtype == torch.int16
    got = stereo.build_channel_candidates(pcm, cfg)
    want = stereo.build_channel_candidates_plain(pcm, cfg)
    if level == 4:
        want += (stereo.loose_assignment(pcm.int(), cfg)[0],)
    assert _same(got, want)
    a11 = seen["k11"]
    assert _same(lpc_ops.window_autocorrelation(*a11),
                 lpc_ops.autocorrelation_plain(*a11))
    choice, x, loose, cfg12, mid_side = seen["k12"]
    assert mid_side and (loose is not None) == (level == 4)
    assert _same(stereo.assign_channels(choice, x, loose, cfg12, mid_side),
                 stereo.assign_channels_plain(choice, x, loose, cfg12))


def test_a_replay_adds_the_launches_of_k10_k11_k12(cuda):
    cfg = EncoderConfig.from_preset(8, blocksize=N).resolve()
    progs = encoder_mod._PROGRAMS
    progs.clear()
    mods = (candidates_cuda, autoc_cuda, assign_cuda)
    try:
        x0 = _blocks(8, cuda)
        for lo in (0, 64, 128):              # the ops, the capture, a replay
            x = torch.roll(x0, lo, dims=-1)
            before = [m.launches for m in mods]
            got = encoder_mod.encode_batch(x, lo, cfg, N)
            torch.cuda.synchronize()
            assert [m.launches - b for m, b in zip(mods, before)] \
                == [1, 1, 1]
            want = encoder_mod._encode_batch_ops(
                x, encoder_mod._frame_numbers(lo, 64, cuda), cfg, N, "auto",
                "kernel")
            assert _same(tuple(got), tuple(want))
        [prog] = progs.graphs.values()
        for name in ("channel_candidates", "window_autoc",
                     "assign_channels"):
            assert prog.kernel_launches[name] == 1, name
    finally:
        progs.clear()


def test_k10_k11_k12_no_host_sync_in_warm_calls(cuda):
    seen = _front_inputs(5, cuda)

    def calls():
        stereo.build_channel_candidates(*seen["k10"])
        lpc_ops.window_autocorrelation(*seen["k11"])
        stereo.assign_channels(*seen["k12"])
    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_k10_k11_k12_refused_launch_raises(cuda):
    """The C entry points refuse what the kernels cannot take (the loose
    sums without the mid-side candidates, a lag past 32 or past N - 1, no
    partition), and the wrappers raise on their error codes and on
    arguments they do not take."""
    z = torch.zeros(64, dtype=torch.int64, device=cuda)
    p = z.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    lib = candidates_cuda._library()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(lib.flac_channel_candidates(
            p, p, p, p, p, 1, 2, 16, 16, 0, 0, 0, stream),
            "flac_channel_candidates")
    lib = autoc_cuda._library()
    for n, lag in ((64, 33), (8, 8)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.check(lib.flac_window_autoc(
                p, p, p, p, 1, n, 1, 1, lag, 0, stream), "flac_window_autoc")
    lib = assign_cuda._library()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(lib.flac_assign_channels(
            *[p] * 30, 1, 16, 0, 0, 0, stream), "flac_assign_channels")
    with pytest.raises(ValueError):
        candidates_cuda.channel_candidates(
            torch.zeros((1, 2, 16), dtype=torch.int64, device=cuda),
            EncoderConfig().resolve())
