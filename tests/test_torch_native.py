"""flac_tpu_torch's copy of the native host runtime against flac_tpu's.

The port builds its own copy of flac_native.cpp (g++, at first use) and
binds it itself.  On streams the port encodes, both bindings must return
the same frame table, the same tile skip-walk tables (every field), the
same full parse, fused decode and host restore, the same ordered frame
gather, and the same CRCs and MD5 digests.  These are ctypes calls: no JAX
compile.
"""

import numpy as np
import pytest
import torch

from flac_tpu import native as jnative
from flac_tpu_torch import EncoderConfig, native, signals
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.decoder_fast import _group_arrays
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.ref_decoder import parse_metadata

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not jnative.AVAILABLE,
                                reason="flac_tpu's native runtime is "
                                       "unavailable")

# name -> (preset, pcm maker, config overrides)
STREAMS = {
    "-5 stereo": (5, lambda: signals.make_test_signal(4096 * 3 + 321,
                                                      seed=1), {}),
    "-8 24-bit": (8, lambda: signals.make_test_signal(
        4096 * 2 + 55, bps=24, seed=2), {"bits_per_sample": 24}),
    "-0 noise mono 8-bit": (0, lambda: np.random.default_rng(3).integers(
        -128, 128, (1, 5000)).astype(np.int32),
        {"bits_per_sample": 8}),
    "partition order 8": (5, lambda: signals.make_test_signal(
        4096 * 2, seed=4), {"min_residual_partition_order": 8,
                            "max_residual_partition_order": 8}),
    "-5 32-bit stereo, 33-bit side": (5, lambda: signals.make_test_signal(
        4096 * 2 + 9, bps=32, seed=5), {"bits_per_sample": 32}),
}


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    preset, make, kw = STREAMS[request.param]
    pcm = make()
    cfg = EncoderConfig.from_preset(preset, channels=pcm.shape[0], **kw)
    data = encode_file_to_flac(pcm, cfg, device="cpu")
    st, pos = parse_metadata(data, 4)
    return data, st, pos


def _groups(frames):
    out = {}
    for i, f in enumerate(frames):
        out.setdefault((f["blocksize"], f["channels"]), []).append(i)
    return out


def test_scan_frames_matches(stream):
    data, st, pos = stream
    got = native.scan_frames(data, pos, st.bits_per_sample, st.sample_rate)
    want = jnative.scan_frames(data, pos, st.bits_per_sample,
                               st.sample_rate)
    assert got == want and len(got) > 1


@pytest.mark.parametrize("T", [128, 16])
def test_tile_scan_matches(stream, T):
    data, st, pos = stream
    frames = scan_frames(data, st, pos)
    arr = np.frombuffer(data, np.uint8)
    for (N, C), idxs in _groups(frames).items():
        table = _group_arrays(frames, idxs, C)
        args = (table[0], table[1], table[2], table[4])
        got = native.tile_scan(arr, *args, N, T=T)
        want = jnative.tile_scan(arr, *args, N, T=T)
        for name in jnative.TileGroup.__slots__:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)


def test_tile_scan_overflows_on_high_partition_orders():
    """Partition order 8 at blocksize 4096 puts 8 partitions in every
    128-sample tile: more segments than the table holds."""
    preset, make, kw = STREAMS["partition order 8"]
    data = encode_file_to_flac(make(), EncoderConfig.from_preset(
        preset, **kw), device="cpu")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    table = _group_arrays(frames, range(len(frames)), 2)
    tg = native.tile_scan(np.frombuffer(data, np.uint8), table[0], table[1],
                          table[2], table[4], 4096)
    assert (tg.status == native.FT_SEG_OVERFLOW).all()


def test_parse_and_decode_frames_match(stream):
    data, st, pos = stream
    frames = scan_frames(data, st, pos)
    arr = np.frombuffer(data, np.uint8)
    for (N, C), idxs in _groups(frames).items():
        off, sb, sz, asg, ch_bps = _group_arrays(frames, idxs, C)
        got = native.parse_frames(arr, off, sb, sz, ch_bps, N)
        want = jnative.parse_frames(arr, off, sb, sz, ch_bps, N)
        for name in jnative.ParsedGroup.__slots__:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        got = native.decode_frames_full(arr, off, sb, sz, ch_bps, N, asg,
                                        check_bps=st.bits_per_sample)
        want = jnative.decode_frames_full(arr, off, sb, sz, ch_bps, N, asg,
                                          check_bps=st.bits_per_sample)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # straight into a [C, total] array at per-frame offsets
        outs = [np.zeros((C, N * len(idxs) + 7), np.int32) for _ in "ab"]
        at = np.arange(len(idxs), dtype=np.int64) * N + 3
        native.decode_frames_full(arr, off, sb, sz, ch_bps, N, asg,
                                  out=outs[0], out_off=at)
        jnative.decode_frames_full(arr, off, sb, sz, ch_bps, N, asg,
                                   out=outs[1], out_off=at)
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("wide", [False, True])
def test_restore_subframes_matches(stream, wide):
    """The host restore of a parsed group, from int32 residuals and from
    int64 ones; the restored subframes are the decoded channels, before
    the stereo undo, with the wasted bits applied."""
    data, st, pos = stream
    frames = scan_frames(data, st, pos)
    arr = np.frombuffer(data, np.uint8)
    for (N, C), idxs in _groups(frames).items():
        off, sb, sz, asg, ch_bps = _group_arrays(frames, idxs, C)
        pg = native.parse_frames(arr, off, sb, sz, ch_bps, N, wide=wide)
        got = native.restore_subframes(pg)
        want = jnative.restore_subframes(jnative.parse_frames(
            arr, off, sb, sz, ch_bps, N, wide=wide))
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        pcm, _, status = native.decode_frames_full(arr, off, sb, sz, ch_bps,
                                                   N, asg)
        if C == 1:
            np.testing.assert_array_equal(got.reshape(pcm.shape), pcm)


def test_fused_decode_takes_a_33bit_side_wide():
    """Antiphase 32-bit stereo (R = -L): a constant mid and a side past
    2^31 whose residuals fit int32.  The port's fused decode restores the
    side in int64; flac_tpu's restores it in int32 and clips, which its
    MD5 then rejects."""
    n = 4096
    left = np.round(1.6e9 * np.sin(np.arange(2 * n) * 0.01)).astype(
        np.int64)
    pcm = np.stack([left, -left]).astype(np.int32)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, bits_per_sample=32), device="cpu")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    assert {f["assignment"] for f in frames} == {3}
    off, sb, sz, asg, ch_bps = _group_arrays(frames, range(len(frames)), 2)
    arr = np.frombuffer(data, np.uint8)
    got, _, status = native.decode_frames_full(arr, off, sb, sz, ch_bps, n,
                                               asg)
    assert (status == native.FT_OK).all()
    np.testing.assert_array_equal(
        got.transpose(1, 0, 2).reshape(2, -1), pcm)
    want, _, _ = jnative.decode_frames_full(arr, off, sb, sz, ch_bps, n,
                                            asg)
    assert not np.array_equal(want, got)


def test_gather_frames_matches():
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 256, (5, 64), dtype=np.uint8)
    for lens in ([64, 0, 1, 63, 17], [0] * 5, [64] * 5):
        assert native.gather_frames(rows, np.array(lens)) == \
            jnative.gather_frames(rows, np.array(lens))
    assert native.gather_frames(rows, np.array([3] * 5)) == b"".join(
        r[:3].tobytes() for r in rows)
    with pytest.raises(ValueError, match="gather_frames"):
        native.gather_frames(rows, np.array([65, 0, 0, 0, 0]))


@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24, 32])
def test_md5_and_crcs_match(bps):
    rng = np.random.default_rng(bps)
    lim = 1 << (bps - 1)
    pcm = rng.integers(-lim, lim, (3, 1001), dtype=np.int64).astype(np.int32)
    hashes = []
    for mod in (native, jnative):
        h = mod.MD5()
        h.update(b"prefix")
        h.update_pcm(pcm[:, :500], bps)
        h.update_pcm(pcm[:, 500:], bps)     # a strided span, hashed in place
        hashes.append(h.digest())
    assert hashes[0] == hashes[1]
    blob = rng.integers(0, 256, 777, dtype=np.uint8).tobytes()
    for n in (0, 1, 7, 8, 9, 777):
        assert native.crc8(blob[:n]) == jnative.crc8(blob[:n])
        assert native.crc16(blob[:n], 0x1234) == jnative.crc16(blob[:n],
                                                               0x1234)


def test_build_step(tmp_path, monkeypatch, capsys):
    """`python -m flac_tpu_torch.native [--force]` builds the runtime and
    says where it is; a failed build exits 1 with the compiler's
    message."""
    from flac_tpu_torch.native import __main__ as build_step
    assert build_step.main([]) == 0
    out = capsys.readouterr().out
    assert str(native.build()) in out and f"ABI v{native.ABI_VERSION}" in out
    broken = tmp_path / "flac_native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert build_step.main(["--force"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("BUILD FAILED") and "flac_native.cpp" in err
    assert not list((tmp_path / "build").glob("*.so"))
