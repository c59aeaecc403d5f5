"""Kernels K6 (csrc/lpc_coeffs.cu, the LPC coefficient stage), K7
(csrc/rice_cost.cu, the Rice cost table), K8 (csrc/candidate_residuals.cu,
the candidate residuals) and K9 (csrc/select_realize.cu, the select and
realize) against their plain PyTorch versions (models/subframe.py
lpc_candidates_plain, _rice_cost_plain, candidate_residuals_plain and
select_and_realize_plain), on a CUDA GPU:

- every corner of ops/search_synth.py: K6's five outputs, K7's three and
  every SubframeChoice field of K9 bit-identical; K8's order_all, f_ok
  and fit_ok bit-identical, and its residual rows wherever their flag
  holds (a wide fixed or "f64" row whose flag is false has no defined
  residuals: residuals_cuda.comparable_rows);
- the search inputs of real 64-frame -5 and -8 batches (the ops form's
  arguments): the same;
- a graph replay adds the launches of K6-K9 its graph holds (one each a
  call) and still equals the ops form;
- no host sync in warm calls of any of the wrappers, or of a warm
  encode, under torch.cuda.set_sync_debug_mode("error");
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
from flac_tpu_torch.ops import lpc_cuda, residuals_cuda, rice_cost_cuda, \
    search_synth, select_cuda

pytestmark = pytest.mark.gpu

N = 4096
LPC_CASES = search_synth.lpc_cases()
RICE_CASES = search_synth.rice_cases()
RESIDUAL_CASES = search_synth.residual_cases()
SELECT_CASES = search_synth.select_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K6-K9 have no CPU mode)")
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


SPIED = {"k6": "lpc_candidates", "k8": "candidate_residuals",
         "k7": "_rice_cost", "k9": "select_and_realize"}


def _search_inputs(level, cuda):
    """The arguments of lpc_candidates (k6), candidate_residuals (k8),
    _rice_cost (k7) and select_and_realize (k9) in the ops form of a
    64-frame batch at -level."""
    cfg = EncoderConfig.from_preset(level, blocksize=N).resolve()
    x = _blocks(level, cuda)
    seen = {}
    real = {key: getattr(subframe, name) for key, name in SPIED.items()}

    def spy(key):
        def call(*a):
            seen[key] = a
            return real[key](*a)
        return call
    for key, name in SPIED.items():
        setattr(subframe, name, spy(key))
    try:
        encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(0, 64, cuda), cfg, N, "auto",
            "kernel")
    finally:
        for key, name in SPIED.items():
            setattr(subframe, name, real[key])
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


def _k8_same(got, want, args):
    return residuals_cuda.same_outputs(got, want, args[5], args[6])


@pytest.mark.parametrize("label,case", RESIDUAL_CASES,
                         ids=[c[0] for c in RESIDUAL_CASES])
def test_k8_matches_plain_on_the_corners(cuda, label, case):
    args = search_synth.as_residual_inputs(case, cuda)
    before = residuals_cuda.launches
    got = subframe.candidate_residuals(*args)
    want = subframe.candidate_residuals_plain(*args)
    torch.cuda.synchronize()
    assert residuals_cuda.launches == before + 1
    assert _k8_same(got, want, args)


@pytest.mark.parametrize("label,case", SELECT_CASES,
                         ids=[c[0] for c in SELECT_CASES])
def test_k9_matches_plain_on_the_corners(cuda, label, case):
    args = search_synth.as_select_inputs(case, cuda)
    before = select_cuda.launches
    got = subframe.select_and_realize(*args)
    want = subframe.select_and_realize_plain(*args)
    torch.cuda.synchronize()
    assert select_cuda.launches == before + 1
    assert _same(got, want)


@pytest.mark.parametrize("level", [5, 8])
def test_k8_and_k9_match_plain_on_a_real_batch(cuda, level):
    seen = _search_inputs(level, cuda)
    assert _k8_same(subframe.candidate_residuals(*seen["k8"]),
                    subframe.candidate_residuals_plain(*seen["k8"]),
                    seen["k8"])
    assert _same(subframe.select_and_realize(*seen["k9"]),
                 subframe.select_and_realize_plain(*seen["k9"]))


def test_a_replay_adds_the_launches_of_k8_and_k9(cuda):
    cfg = EncoderConfig.from_preset(8, blocksize=N).resolve()
    progs = encoder_mod._PROGRAMS
    progs.clear()
    try:
        x0 = _blocks(8, cuda)
        for lo in (0, 64, 128):              # the ops, the capture, a replay
            x = torch.roll(x0, lo, dims=-1)
            k8, k9 = residuals_cuda.launches, select_cuda.launches
            got = encoder_mod.encode_batch(x, lo, cfg, N)
            torch.cuda.synchronize()
            assert (residuals_cuda.launches - k8,
                    select_cuda.launches - k9) == (1, 1)
            want = encoder_mod._encode_batch_ops(
                x, encoder_mod._frame_numbers(lo, 64, cuda), cfg, N, "auto",
                "kernel")
            assert _same(got, want)
        [prog] = progs.graphs.values()
        assert prog.kernel_launches["candidate_residuals"] == 1
        assert prog.kernel_launches["select_realize"] == 1
    finally:
        progs.clear()


def test_k8_k9_no_host_sync_in_warm_calls(cuda):
    seen = _search_inputs(5, cuda)
    subframe.candidate_residuals(*seen["k8"])
    subframe.select_and_realize(*seen["k9"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        subframe.candidate_residuals(*seen["k8"])
        subframe.select_and_realize(*seen["k9"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_k8_k9_refused_launch_raises(cuda):
    """The C entry points refuse what the kernels cannot take (an int64
    signal on the narrow paths, a tap bound past 32, no partition
    orders), and the wrappers raise on their error codes."""
    z = torch.zeros(64, dtype=torch.int64, device=cuda)
    p = z.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    lib = residuals_cuda._library()
    for x64, max_j in ((1, 8), (0, 33)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.check(lib.flac_candidate_residuals(
                *[p] * 9, 1, 1, 16, max_j, x64, 0, 0, stream),
                "flac_candidate_residuals")
    lib = select_cuda._library()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(lib.flac_select_realize(
            *[p] * 25, 1, 0, 16, 0, 1, 0, stream), "flac_select_realize")
    with pytest.raises(ValueError):
        residuals_cuda.candidate_residuals(
            torch.zeros((1, 2, 16), dtype=torch.int64, device=cuda),
            torch.zeros((1, 2, 1, 32), dtype=torch.int32, device=cuda),
            *(torch.zeros((1, 2, 1), dtype=torch.int32, device=cuda)
              for _ in range(2)),
            torch.zeros((1, 2), dtype=torch.int32, device=cuda), False,
            "i32", 8)
