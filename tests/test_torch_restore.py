"""Kernel K3 (the restore, csrc/restore.cu) and its wrapper.

On the CPU, `restore_cuda.restore_undo` takes the plain version
(`bitunpack.restore_undo_body`); it must be bit-identical to flac_tpu's
restore_undo_body (the XLA scan, run by JAX on the CPU) on the synthetic
corners of `ops/restore_synth.py` and on a real parsed batch.  The tests
marked `gpu` hold the kernel against the plain version on a CUDA GPU and
skip without one.  JAX is imported inside the CPU tests only, so the card
can run this file without it:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_restore.py -m gpu
"""

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, native, signals
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.decoder_fast import _parse_batch, restore_inputs
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ops import bitunpack, restore_cuda, restore_synth
from flac_tpu_torch.ref_decoder import parse_metadata

torch.set_num_threads(1)

CASES = restore_synth.cases()
IDS = [c[0] for c in CASES]


def _tensors(arrays, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _args(t, kw):
    """The positional arguments of restore_undo_body (res cut to N)."""
    return (t["res"][:, :kw["blocksize"]], t["order"], t["shift"], t["qlp"],
            t["wasted"], t["assignment"])


def _reference(arrays, kw):
    """flac_tpu's restore_undo_body on the same numpy inputs."""
    import jax.numpy as jnp

    from flac_tpu.ops.bitunpack import restore_undo_body
    res = np.ascontiguousarray(arrays["res"][:, :kw["blocksize"]])
    pcm, oor = restore_undo_body(
        jnp.asarray(res), *(jnp.asarray(arrays[k]) for k in
                            ("order", "shift", "qlp", "wasted",
                             "assignment")), unroll=2, **kw)
    return np.asarray(pcm), np.asarray(oor)


def _parsed_batch(preset: int, n: int = 1152 * 3 + 200):
    """The restore inputs of the first native.parse_frames batch of a short
    port-encoded stream, as the fast engine builds them."""
    pcm = signals.make_test_signal(n, seed=preset)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        preset, blocksize=1152), device="cpu")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    idxs = [i for i, f in enumerate(frames) if f["blocksize"] == 1152]
    pg, asg = _parse_batch(np.frombuffer(data, np.uint8), frames, idxs,
                           1152, 2)
    assert (pg.status == native.FT_OK).all()
    arrays, kw = restore_inputs(pg, asg, 1152, 2, 16)
    assert arrays[0].dtype == np.int16 and kw["out16"]
    return dict(zip(("res", "order", "shift", "qlp", "wasted",
                     "assignment"), arrays)), kw


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_plain_restore_matches_flac_tpu(case):
    label, arrays, kw = CASES[case]
    before = restore_cuda.launches
    pcm, oor = restore_cuda.restore_undo(*_args(_tensors(arrays), kw), **kw)
    assert restore_cuda.launches == before      # the CPU runs no kernel
    want_pcm, want_oor = _reference(arrays, kw)
    assert pcm.numpy().dtype == want_pcm.dtype, label
    np.testing.assert_array_equal(pcm.numpy(), want_pcm, err_msg=label)
    np.testing.assert_array_equal(oor.numpy(), want_oor, err_msg=label)


def test_cases_reach_wrap_and_flags():
    """The corners are really there: the wrap case leaves int32 range in
    int64 arithmetic, the flag cases flag some frames and not others."""
    by_label = {c[0]: c for c in CASES}
    _, arrays, kw = by_label[
        "narrow int32 wrap (random 15-bit taps, 24-bit residuals)"]
    wide_kw = dict(kw, wide=True)
    t = _tensors(arrays)
    narrow, _ = restore_cuda.restore_undo(*_args(t, kw), **kw)
    wide, _ = restore_cuda.restore_undo(*_args(t, wide_kw), **wide_kw)
    assert not torch.equal(narrow.to(torch.int64), wide)
    for label in ("out16 with bps-range flags (16-bit)",
                  "bps-range flags at 8 and 24 bits: 24-bit",
                  "stereo, every assignment"):
        _, arrays, kw = by_label[label]
        _, oor = restore_cuda.restore_undo(*_args(_tensors(arrays), kw),
                                           **kw)
        assert 0 < int(oor.sum()) < oor.numel(), label


def test_plain_restore_matches_flac_tpu_on_a_parsed_batch():
    arrays, kw = _parsed_batch(5)
    pcm, oor = restore_cuda.restore_undo(*_args(_tensors(arrays), kw), **kw)
    want_pcm, want_oor = _reference(arrays, kw)
    np.testing.assert_array_equal(pcm.numpy(), want_pcm)
    np.testing.assert_array_equal(oor.numpy(), want_oor)
    assert not oor.any()


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_host_mirror_matches_plain(case):
    """The kernel's arithmetic in numpy (lookahead accumulators, the folded
    shift, the per-CTA rule, rounds and warm-up) equals the plain version."""
    label, arrays, kw = CASES[case]
    pcm, oor = bitunpack.restore_undo_body(*_args(_tensors(arrays), kw), **kw)
    mpcm, moor = restore_cuda.mirror_restore(
        *(arrays[k] for k in ("res", "order", "shift", "qlp", "wasted",
                              "assignment")), **kw)
    assert mpcm.dtype == pcm.numpy().dtype, label
    np.testing.assert_array_equal(mpcm, pcm.numpy(), err_msg=label)
    np.testing.assert_array_equal(moor, oor.numpy(), err_msg=label)


def test_folded_rule_takes_the_generic_path_where_it_must():
    """No subframe whose taps pass 16 signed bits or whose shift is outside
    0..31 folds, nor any other subframe of its CTA, nor a wide batch; the
    corners reach both forms."""
    seen = set()
    for label, arrays, kw in CASES:
        q = arrays["qlp"][:, :kw["max_order"]].astype(np.int64)
        sh = arrays["shift"].astype(np.int64)
        fold = restore_cuda.folded_subframes(q, sh, kw["wide"])
        ok = ((q >= -(1 << 15)) & (q < 1 << 15)).all(1) & (sh >= 0) \
            & (sh <= 31)
        assert not (fold & ~ok).any(), label
        cta = np.arange(len(sh)) // restore_cuda.SUBS
        for c in np.unique(cta):
            f = fold[cta == c]
            want = ok[cta == c].all() and not kw["wide"]
            assert f.all() == want and f.any() == want, label
        seen.update(fold.tolist())
    assert seen == {False, True}


def test_ring_fits_the_card():
    """The widest launch's dynamic shared memory (int64 residuals, int64
    samples) fits the 227 KB a CTA may take on an H100."""
    assert restore_cuda.smem_bytes(8, True) <= 232448
    assert restore_cuda.K % restore_cuda.round_len(12) == 0
    assert all(restore_cuda.K % restore_cuda.round_len(m) == 0
               for m in restore_cuda.ORDER_BUCKETS)


def test_kernel_order_buckets():
    assert [restore_cuda.kernel_order(m) for m in (0, 1, 3, 5, 8, 9, 13, 17,
                                                   32)] == \
        [1, 1, 4, 8, 8, 12, 16, 32, 32]
    with pytest.raises(ValueError, match="max_order"):
        restore_cuda.kernel_order(33)


def test_restore_undo_rejects_other_devices():
    _, arrays, kw = CASES[0]
    t = _tensors(arrays, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        restore_cuda.restore_undo(*_args(t, kw), **kw)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K3 has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(arrays, kw, device):
    t = _tensors(arrays, device)
    before = restore_cuda.launches
    kpcm, koor = restore_cuda.restore_undo(*_args(t, kw), **kw)
    ppcm, poor = bitunpack.restore_undo_body(*_args(t, kw), **kw)
    torch.cuda.synchronize()
    assert restore_cuda.launches == before + 1
    assert kpcm.dtype == ppcm.dtype
    assert torch.equal(kpcm, ppcm)
    assert torch.equal(koor, poor)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_k3_matches_plain(cuda, case):
    _, arrays, kw = CASES[case]
    _kernel_vs_plain(arrays, kw, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", [5, 8])
def test_k3_matches_plain_on_a_parsed_batch(cuda, preset):
    arrays, kw = _parsed_batch(preset)
    _kernel_vs_plain(arrays, kw, cuda)
    # int32 residuals as the code scan gives them, and no narrowing
    arrays = dict(arrays, res=arrays["res"].astype(np.int32))
    _kernel_vs_plain(arrays, dict(kw, out16=False), cuda)


@pytest.mark.gpu
def test_k3_raises_on_a_bad_argument(cuda):
    _, arrays, kw = CASES[0]
    t = _tensors(arrays, cuda)
    args = list(_args(t, kw))
    args[3] = args[3].to(torch.int64)
    with pytest.raises(ValueError, match="qlp"):
        restore_cuda.restore_undo(*args, **kw)
