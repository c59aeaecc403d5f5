"""The device decoder's code scan and restore, held bit-identical to
flac_tpu's on the CPU.

`rice_codes_plain` (kernel K2's plain version) plus `restore_undo_body`
against `flac_tpu.ops.bitunpack.rice_decode_restore`, which takes its XLA
branch on the CPU (its Pallas kernel is probed away there), on the tile
tables of a stream the port encodes and on the synthetic lanes of
`ops/rice_synth.py` (second-stage unary runs, runs of 128 or more, raw
widths 0 to 63, a lane past its window, a lane that spends all its segment
slots).  Both share one compile per width: same shapes, same static
arguments.  The CUDA kernel needs a GPU: test_torch_rice_cuda.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu.decoder_fast import restore_and_undo
from flac_tpu.ops import bitunpack as jbu
from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch import decoder_device as tdd
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ops import bitunpack as tbu
from flac_tpu_torch.ops import rice_cuda, rice_synth
from flac_tpu_torch.ref_decoder import parse_metadata

torch.set_num_threads(1)

N = 1024                 # 8 tiles of 128 samples
F, C = 8, 2
L = F * C * (N // 128)   # 128 lanes


def stream_batch():
    """The host arrays of a -8 stereo batch of 8 frames, as the device
    engine builds them."""
    pcm = signals.make_test_signal(N * F, seed=8)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        8, blocksize=N), device="cpu")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    arr = np.frombuffer(data, np.uint8)
    prep = tdd._prep_batch(arr, frames, list(range(F)), N, C)
    arrays, kw = tdd.batch_inputs(arr, *prep)
    assert kw["NROW"] <= rice_synth.NROW and not kw["wide"]
    # all SEG columns of the tables (unused ones hold the inert segment)
    arrays = arrays[:2] + (prep[0].segs,) + arrays[3:]
    return arrays, kw["max_order"], pcm


def synthetic_batch(wide, max_order):
    """The synthetic lanes as a batch of order-0 subframes (restore is the
    identity there), with independent channels."""
    words2d, lane_start, segs = rice_synth.synthetic_lanes(
        5, wide=wide, lanes=L)
    S = F * C
    zeros = np.zeros(S, np.int32)
    return (words2d, lane_start, segs, zeros, zeros,
            np.zeros((S, max_order), np.int32), zeros,
            np.zeros(F, np.int32))


def pad_rows(words2d, R):
    return np.pad(words2d, ((0, R - len(words2d)), (0, 0)))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_rice_decode_restore_matches_reference(wide):
    real, mo, pcm = stream_batch()
    synth = synthetic_batch(wide, mo)
    # one shape for both batches: the same window rows, segment slots and
    # word rows (zero rows past the guard row read as it does)
    R = max(len(real[0]), len(synth[0]))
    static = dict(T=128, NROW=rice_synth.NROW, SEG=rice_synth.SEG,
                  blocksize=N, channels=C, max_order=mo, wide=wide,
                  out16=False, bps=16)
    for name, arrays in (("stream", real), ("synthetic", synth)):
        arrays = (pad_rows(arrays[0], R),) + tuple(arrays[1:])
        want = jbu.rice_decode_restore(
            jnp.asarray(arrays[0].view(np.uint32)),
            *[jnp.asarray(a) for a in arrays[1:]], **static)
        got = tbu.rice_decode_restore(
            *[torch.from_numpy(a) for a in arrays], **static)
        for what, w, g in zip(("pcm", "oor", "lane_ovf"), want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, (name, what)
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} {what}")
        if name == "stream":
            np.testing.assert_array_equal(
                np.asarray(want[0]).transpose(1, 0, 2).reshape(C, -1), pcm)
        else:
            ovf = np.asarray(want[2])
            assert ovf[[34, 35, 70]].all() and ovf.sum() == 3
            if wide:   # values of 2^32 and more came through
                assert np.abs(np.asarray(want[0])).max() >= 1 << 32


@pytest.mark.parametrize("mode", ["out16", "int32", "wide"])
def test_restore_undo_body_matches_reference(mode):
    """Every stereo assignment, orders 0..8, wasted bits, shifts, and
    random taps that blow past 16 bits (the out-of-range flags and the
    int32 wrap-around are part of the contract)."""
    rng = np.random.default_rng(len(mode))
    S, n, mo = 16, 64, 8
    wide = mode == "wide"
    res = rng.integers(-3000, 3000, (S, n)).astype(
        np.int64 if wide else np.int32)
    if wide:
        res[8::3] <<= 20
    order = rng.integers(0, mo + 1, S).astype(np.int32)
    shift = rng.integers(0, 13, S).astype(np.int32)
    qlp = rng.integers(-600, 600, (S, mo)).astype(np.int32)
    qlp[:8] = 0              # the first 4 frames stay in range
    wasted = rng.integers(0, 3, S).astype(np.int32)
    asg = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    static = dict(blocksize=n, channels=2, max_order=mo, wide=wide,
                  out16=mode == "out16", bps=16)
    args = (res, order, shift, qlp, wasted, asg)
    want = restore_and_undo(*[jnp.asarray(a) for a in args], **static)
    got = tbu.restore_undo_body(*[torch.from_numpy(a) for a in args],
                                **static)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    oor = np.asarray(want[1])
    assert oor.any() and not oor.all()


def test_rice_codes_wrapper_uses_the_plain_version_on_the_cpu():
    words2d, lane_start, segs = rice_synth.synthetic_lanes(2)
    args = [torch.from_numpy(a) for a in (words2d, lane_start, segs)]
    kw = dict(T=rice_synth.T, NROW=rice_synth.NROW, SEG=rice_synth.SEG,
              wide=False)
    before = rice_cuda.launches
    res, ovf = rice_cuda.rice_codes(*args, **kw)
    pres, povf = tbu.rice_codes_plain(*args, **kw)
    assert rice_cuda.launches == before
    assert torch.equal(res, pres) and torch.equal(ovf, povf)
    assert res.shape == (rice_synth.T, len(lane_start))
    with pytest.raises(ValueError, match="not on the GPU"):
        rice_cuda.rice_codes_cuda(*args, **kw)


def test_probe_expectation():
    """P2 compares the card against this host reckoning; the reference's
    probe expects 27 + 16 for v = 16."""
    v = np.array([16, 0, 1, 7, 0xFFFFFFFF, 0x80000000, 12345], np.uint32)
    got = rice_cuda.probe_expected(v).view(np.uint32)
    want = [(32 - int(x).bit_length() + (int(x) >> (int(x) & 7)))
            & 0xFFFFFFFF for x in v]
    assert got.tolist() == want and got[0] == 43
