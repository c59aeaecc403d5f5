"""Kernels K6 (csrc/lpc_coeffs.cu, the LPC coefficient stage) and K7
(csrc/rice_cost.cu, the Rice cost table) against their plain PyTorch
versions (models/subframe.py lpc_candidates_plain and _rice_cost_plain),
on a CUDA GPU:

- every corner of ops/search_synth.py: K6's five outputs and K7's three
  bit-identical;
- the search inputs of real 64-frame -5 and -8 batches (the ops form's
  arguments): the same;
- a graph replay adds the launches of K6 and K7 its graph holds (one
  each a call) and still equals the ops form;
- no host sync in warm calls of either wrapper, or of a warm encode,
  under torch.cuda.set_sync_debug_mode("error");
- a launch the kernel refuses raises.

Every test here carries the `gpu` marker and skips without a GPU (the
plain versions are held against flac_tpu in test_torch_search.py).  The
file imports neither JAX nor flac_tpu:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_search_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, kernels, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.models import subframe
from flac_tpu_torch.ops import lpc_cuda, rice_cost_cuda, search_synth

pytestmark = pytest.mark.gpu

N = 4096
LPC_CASES = search_synth.lpc_cases()
RICE_CASES = search_synth.rice_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K6 and K7 have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("label,case", LPC_CASES,
                         ids=[c[0] for c in LPC_CASES])
def test_k6_matches_plain_on_the_corners(cuda, label, case):
    args = search_synth.as_lpc_inputs(case, cuda)
    before = lpc_cuda.launches
    got = subframe.lpc_candidates(*args)
    want = subframe.lpc_candidates_plain(*args)
    torch.cuda.synchronize()
    assert lpc_cuda.launches == before + 1
    assert _same(got, want)


@pytest.mark.parametrize("label,case", RICE_CASES,
                         ids=[c[0] for c in RICE_CASES])
def test_k7_matches_plain_on_the_corners(cuda, label, case):
    args = search_synth.as_rice_inputs(case, cuda)
    before = rice_cost_cuda.launches
    got = subframe._rice_cost(*args)
    want = subframe._rice_cost_plain(*args)
    torch.cuda.synchronize()
    assert rice_cost_cuda.launches == before + 1
    assert _same(got, want)


def _blocks(level, cuda, frames=64):
    pcm = signals.make_test_signal(frames * N, seed=60 + level)
    return torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, frames, N).transpose(1, 0, 2))).to(cuda)


def _search_inputs(level, cuda):
    """The arguments of lpc_candidates and _rice_cost in the ops form of a
    64-frame batch at -level."""
    cfg = EncoderConfig.from_preset(level, blocksize=N).resolve()
    x = _blocks(level, cuda)
    seen = {}
    lpc, rice = subframe.lpc_candidates, subframe._rice_cost

    def spy_lpc(*a):
        seen["k6"] = a
        return lpc(*a)

    def spy_rice(*a):
        seen["k7"] = a
        return rice(*a)
    subframe.lpc_candidates, subframe._rice_cost = spy_lpc, spy_rice
    try:
        encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(0, 64, cuda), cfg, N, "auto",
            "kernel")
    finally:
        subframe.lpc_candidates, subframe._rice_cost = lpc, rice
    return seen


@pytest.mark.parametrize("level", [5, 8])
def test_k6_and_k7_match_plain_on_a_real_batch(cuda, level):
    seen = _search_inputs(level, cuda)
    assert _same(subframe.lpc_candidates(*seen["k6"]),
                 subframe.lpc_candidates_plain(*seen["k6"]))
    assert _same(subframe._rice_cost(*seen["k7"]),
                 subframe._rice_cost_plain(*seen["k7"]))


def test_a_replay_adds_the_launches_of_k6_and_k7(cuda):
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    progs = encoder_mod._PROGRAMS
    progs.clear()
    try:
        x0 = _blocks(5, cuda)
        for lo in (0, 64, 128):              # the ops, the capture, a replay
            x = torch.roll(x0, lo, dims=-1)
            k6, k7 = lpc_cuda.launches, rice_cost_cuda.launches
            got = encoder_mod.encode_batch(x, lo, cfg, N)
            torch.cuda.synchronize()
            assert (lpc_cuda.launches - k6, rice_cost_cuda.launches - k7) \
                == (1, 1)
            want = encoder_mod._encode_batch_ops(
                x, encoder_mod._frame_numbers(lo, 64, cuda), cfg, N, "auto",
                "kernel")
            assert _same(got, want)
        [prog] = progs.graphs.values()
        assert prog.kernel_launches["lpc_coeffs"] == 1
        assert prog.kernel_launches["rice_cost"] == 1
    finally:
        progs.clear()


def test_no_host_sync_in_warm_calls(cuda):
    seen = _search_inputs(5, cuda)
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    x = _blocks(5, cuda)
    encoder_mod._PROGRAMS.clear()
    try:
        encoder_mod.encode_batch(x, 0, cfg, N)       # the ops
        encoder_mod.encode_batch(x, 0, cfg, N)       # the capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            subframe.lpc_candidates(*seen["k6"])
            subframe._rice_cost(*seen["k7"])
            encoder_mod.encode_batch(x, 0, cfg, N)   # a replay
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        encoder_mod._PROGRAMS.clear()


def test_a_refused_launch_raises(cuda):
    """The C entry points refuse what the kernels cannot take, and the
    wrappers raise on their error codes."""
    lib = lpc_cuda._library()
    z = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(lib.flac_lpc_coeffs(
            z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(),
            z.data_ptr(), z.data_ptr(), z.data_ptr(), 1, 1, 40, N, 0, 0, 12,
            torch.cuda.current_stream().cuda_stream), "flac_lpc_coeffs")
    lib = rice_cost_cuda._library()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(lib.flac_rice_cost(
            z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(), None,
            z.data_ptr(), 1, 96, 6, 0, 0, 0,
            torch.cuda.current_stream().cuda_stream), "flac_rice_cost")
    with pytest.raises(ValueError):
        rice_cost_cuda.rice_cost(
            torch.zeros((2, 96), dtype=torch.int32, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda), 96, 6,
            EncoderConfig.from_preset(5, blocksize=96).resolve())
