"""Kernels K4 (csrc/assemble_fields.cu, the field lists) and K5
(csrc/frame_crc.cu, the CRC seal) against their plain PyTorch versions
(models/frame.py assemble_fields_plain and seal_frames_plain), on a CUDA
GPU:

- every corner of ops/assemble_synth.py: K4's six outputs bit-identical,
  and K5 on the plain-packed words identical to the plain seal;
- K5's own corners (assemble_synth.seal_cases: every residue of
  byte_len - 2 mod 16, the longest header, minimal frames, a carrying
  CRC-8 deposit, one frame, 64 and 256 frames, and past the plain
  version's domain byte_len - 2 past the row, byte_len below 2, an odd
  W): identical to the host seal, and to the plain seal in its domain;
- real -5 and -8 batches of 64 frames whose subframe choice comes from
  the ops form: K4 -> K1 -> K5 against plain -> plain -> plain, word for
  word;
- a graph replay adds the launches of K6, K7, K4, K1 and K5 its graph
  holds, and still equals the ops form, in the quad and the safe layout.

Every test here carries the `gpu` marker and skips without a GPU (the
plain versions are held against flac_tpu in test_torch_assemble.py).  The
file imports neither JAX nor flac_tpu:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_assemble_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.models import frame
from flac_tpu_torch.ops import (assemble_cuda, assemble_synth, bitpack,
                                pack_cuda, seal_cuda)

pytestmark = pytest.mark.gpu

N = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K4 and K5 have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _chain(args, kernels: bool):
    """fields -> pack -> seal, through the kernels or the plain versions."""
    choice, signal, _, _, cfg, _, layout = args
    B, C, n = signal.shape
    P = choice.params.shape[-1]
    quad, _ = frame.resolve_layout(cfg, n, P, layout)
    W = frame.max_words(cfg, C, n, P)
    f = (frame.assemble_fields if kernels else frame.assemble_fields_plain)(
        *args)
    if not quad:
        pack = bitpack.pack_fields
    else:
        pack = pack_cuda.pack_fields64 if kernels else bitpack.pack_fields64
    words, total = pack(f.nzeros, f.payload, f.pbits, W)
    seal = frame.seal_frames if kernels else frame.seal_frames_plain
    return f, seal(words, total // 8, f.hdr_bytes), total // 8


CASES = assemble_synth.cases()


@pytest.mark.parametrize("label,case", CASES, ids=[c[0] for c in CASES])
def test_k4_and_k5_match_plain_on_the_corners(cuda, label, case):
    args = assemble_synth.as_inputs(case, cuda)
    k4, k5 = assemble_cuda.launches, seal_cuda.launches
    got = frame.assemble_fields(*args)
    want = frame.assemble_fields_plain(*args)
    torch.cuda.synchronize()
    assert assemble_cuda.launches == k4 + 1
    assert _same(got, want)
    choice, signal, _, _, cfg, _, layout = args
    B, C, n = signal.shape
    P = choice.params.shape[-1]
    quad, _ = frame.resolve_layout(cfg, n, P, layout)
    pack = bitpack.pack_fields64 if quad else bitpack.pack_fields
    words, total = pack(want.nzeros, want.payload, want.pbits,
                        frame.max_words(cfg, C, n, P))
    plain = frame.seal_frames_plain(words, total // 8, want.hdr_bytes)
    sealed = frame.seal_frames(words.clone(), total // 8, want.hdr_bytes)
    torch.cuda.synchronize()
    assert seal_cuda.launches == k5 + 1
    assert torch.equal(sealed, plain)


SEAL = assemble_synth.seal_cases()


@pytest.mark.parametrize("label,case", SEAL, ids=[c[0] for c in SEAL])
def test_k5_matches_the_host_seal_on_its_corners(cuda, label, case):
    words, byte_len, hdr = assemble_synth.as_seal_inputs(case, cuda)
    k5 = seal_cuda.launches
    got = frame.seal_frames(words.clone(), byte_len, hdr)
    torch.cuda.synchronize()
    assert seal_cuda.launches == k5 + 1
    want = assemble_synth.seal_host(case["words"], case["byte_len"],
                                    case["hdr_bytes"])
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if case["plain"]:
        assert torch.equal(got, frame.seal_frames_plain(words, byte_len,
                                                        hdr))


def _real_inputs(level, cuda):
    """assemble_fields' arguments of a 64-frame batch of the ops form."""
    cfg = EncoderConfig.from_preset(level, blocksize=N).resolve()
    pcm = signals.make_test_signal(64 * N, seed=40 + level)
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, 64, N).transpose(1, 0, 2))).to(cuda)
    seen = []
    real = frame.assemble_fields

    def spy(*a):
        seen.append(a)
        return real(*a)
    frame.assemble_fields = spy
    try:
        encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(0, 64, cuda), cfg, N, "auto",
            "kernel")
    finally:
        frame.assemble_fields = real
    return seen[0]


@pytest.mark.parametrize("level", [5, 8])
def test_the_chain_matches_plain_on_a_real_batch(cuda, level):
    args = _real_inputs(level, cuda)
    fk, wk, lk = _chain(args, kernels=True)
    fp, wp, lp = _chain(args, kernels=False)
    torch.cuda.synchronize()
    assert _same(fk, fp)
    assert torch.equal(lk, lp) and torch.equal(wk, wp)


@pytest.mark.parametrize("layout", ["auto", "safe"])
def test_a_replay_adds_the_kernels_launches(cuda, monkeypatch, layout):
    progs = encoder_mod._EncodePrograms()
    monkeypatch.setattr(encoder_mod, "_PROGRAMS", progs)
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    mods = encoder_mod.COUNTED_KERNELS
    steps = []
    for call in range(4):
        pcm = signals.make_test_signal(8 * N, seed=50 + call)
        x = torch.from_numpy(np.ascontiguousarray(
            pcm.reshape(2, 8, N).transpose(1, 0, 2))).to(cuda)
        before = {k: (m.launches, m.captured) for k, m in mods.items()}
        got = encoder_mod.encode_batch(x, 8 * call, cfg, N, layout=layout)
        torch.cuda.synchronize()
        steps.append({k: (m.launches - before[k][0],
                          m.captured - before[k][1])
                      for k, m in mods.items()})
        want = encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(8 * call, 8, cuda), cfg, N,
            layout, "kernel")
        assert _same(got, want), f"call {call}"
    k1 = 1 if layout == "auto" else 0
    expect = {"channel_candidates": 1, "window_autoc": 1, "lpc_coeffs": 1,
              "candidate_residuals": 1, "rice_cost": 1,
              "select_realize": 1, "pack_fields64": k1,
              "assemble_fields": 1, "frame_crc": 1, "assign_channels": 1}
    # the ops launch; the capture records and replays; replays
    for k, n in expect.items():
        assert [s[k] for s in steps] == [(n, 0), (n, n), (n, 0), (n, 0)], k
    [prog] = progs.graphs.values()
    assert prog.kernel_launches == expect
