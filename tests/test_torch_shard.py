"""flac_tpu_torch.parallel.shard against flac_tpu.parallel.shard, on the CPU.

The cases of tests/test_shard.py at its shapes (N = 512, 16 frames and a
ragged 11): a frame's bytes do not depend on how many mesh entries its
batch was split over (a mesh entry may repeat a device, so `("cpu",) * 8`
is eight shards), they equal flac_tpu's at -0 and the frames that the
port's StreamEncoder writes; the sharded decode equals flac_tpu's on a
flac_tpu-encoded stream over 1 and 8 entries, and gives the right samples
of a 32-bit mid-side clip, where flac_tpu's does not.
"""

import io

import jax
import numpy as np
import pytest
import torch

import flac_tpu
from flac_tpu.decoder import parse_metadata as ref_parse_metadata
from flac_tpu.decoder import scan_frames as ref_scan_frames
from flac_tpu.encoder import encode_file_to_flac as ref_encode
from flac_tpu.parallel import shard as ref_shard
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac
from flac_tpu_torch.parallel.shard import (data_mesh, decode_frames_dp,
                                           encode_batch_sharded,
                                           encode_blocks_dp)
from flac_tpu_torch.ref_decoder import parse_metadata

from conftest import make_test_signal

torch.set_num_threads(1)

N = 512
ONE, EIGHT = ("cpu",), ("cpu",) * 8


def _blocks(nframes, seed=0):
    pcm = make_test_signal(N * nframes, seed=seed)
    return pcm.reshape(2, nframes, N).transpose(1, 0, 2), pcm


def _frame_bytes(words, lens):
    return [words[i].astype(">u4").tobytes()[:int(lens[i])]
            for i in range(len(lens))]


@pytest.mark.parametrize("nframes", [16, 11])
@pytest.mark.parametrize("preset", [0, 5])
def test_byte_identity_1_vs_8_entries(preset, nframes):
    """16 frames, and a ragged 11 padded to the mesh: the padding does not
    leak out, and every frame's bytes are the same over 1 and 8 entries."""
    blocks, _ = _blocks(nframes)
    cfg = EncoderConfig.from_preset(preset, blocksize=N).resolve()
    w1, l1 = encode_blocks_dp(blocks, 0, cfg, data_mesh(ONE))
    w8, l8 = encode_blocks_dp(blocks, 0, cfg, data_mesh(EIGHT))
    assert w1.dtype == w8.dtype == np.uint32 and l1.dtype == np.int32
    assert w8.shape[0] == l8.shape[0] == nframes
    np.testing.assert_array_equal(l1, l8)
    assert _frame_bytes(w1, l1) == _frame_bytes(w8, l8)


def test_byte_identity_vs_flac_tpu():
    """At -0 the port's words and lengths are flac_tpu's, frame for frame,
    over 8 entries against flac_tpu's 1-device mesh."""
    blocks, _ = _blocks(16)
    w, lens = encode_blocks_dp(
        blocks, 7, EncoderConfig.from_preset(0, blocksize=N).resolve(),
        data_mesh(EIGHT))
    rw, rlens = ref_shard.encode_blocks_dp(
        blocks, 7, flac_tpu.EncoderConfig.from_preset(0, blocksize=N)
        .resolve(), ref_shard.data_mesh(jax.devices()[:1]))
    np.testing.assert_array_equal(lens, rlens)
    assert _frame_bytes(w, lens) == _frame_bytes(rw, rlens)


def test_byte_identity_vs_stream_encoder():
    """The sharded frames are the frames StreamEncoder writes (-3)."""
    blocks, pcm = _blocks(8)
    cfg = EncoderConfig.from_preset(3, blocksize=N).resolve()
    w, lens = encode_blocks_dp(blocks, 0, cfg, data_mesh(EIGHT))
    buf = io.BytesIO()
    with StreamEncoder(buf, cfg, batch_frames=8, padding=0,
                       device="cpu") as enc:
        enc.process(pcm)
        enc.finish()
    assert b"".join(_frame_bytes(w, lens)) in buf.getvalue()


def test_sharded_batch_numbers_frames_per_shard():
    """encode_batch_sharded returns one PackedFrames a shard, in order,
    numbered from first_frame_number; a batch that does not split evenly
    is refused."""
    blocks, _ = _blocks(8)
    cfg = EncoderConfig.from_preset(0, blocksize=N).resolve()
    shards = encode_batch_sharded(blocks, 100, cfg, N, data_mesh(("cpu",) * 4))
    whole, = encode_batch_sharded(blocks, 100, cfg, N, data_mesh(ONE))
    assert [pf.words.shape[0] for pf in shards] == [2] * 4
    assert torch.equal(torch.cat([pf.byte_len for pf in shards]),
                       whole.byte_len)
    with pytest.raises(ValueError, match="equal shards"):
        encode_batch_sharded(blocks, 0, cfg, N, data_mesh(("cpu",) * 3))


def test_data_mesh():
    assert data_mesh(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        data_mesh([])


@pytest.fixture(scope="module")
def ref_stream():
    """tests/test_shard.py's decode case: 8 frames of 4096 at -5 through
    flac_tpu."""
    pcm = make_test_signal(4096 * 8)
    data = ref_encode(pcm, flac_tpu.EncoderConfig.from_preset(5),
                      batch_frames=8)
    st, pos = parse_metadata(data, 4)
    return pcm, data, st, scan_frames(data, st, pos)


@pytest.mark.parametrize("entries", [1, 3, 8])
def test_decode_matches_flac_tpu(ref_stream, entries):
    """The port's sharded decode equals flac_tpu's (8 devices) and the
    source, over 1 entry, 3 (an uneven split) and 8."""
    pcm, data, st, frames = ref_stream
    out = decode_frames_dp(data, st, frames, data_mesh(("cpu",) * entries))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, pcm)
    rst, rpos = ref_parse_metadata(data, 4)
    ref = ref_shard.decode_frames_dp(data, rst, ref_scan_frames(
        data, rst, rpos), ref_shard.data_mesh(jax.devices()[:8]))
    np.testing.assert_array_equal(out, ref)


def test_decode_raises_on_a_bad_crc(ref_stream):
    pcm, data, st, frames = ref_stream
    bad = bytearray(data)
    bad[frames[2]["offset"] + frames[2]["size"] // 2] ^= 0x10
    with pytest.raises(Exception, match="frame 2"):
        decode_frames_dp(bytes(bad), st, frames, data_mesh(("cpu",) * 2))


def _correlated(n):
    """tests/test_torch_hires.py's correlated 32-bit stereo: mid-side
    frames whose residuals fit int32 while the undo's `mid << 1` does
    not."""
    rng = np.random.default_rng(3)
    base = (np.sin(2 * np.pi * 440 * np.arange(n) / 96000)
            * (1 << 30)).astype(np.int64)
    noise = rng.integers(-(1 << 12), 1 << 12, n)
    return np.stack([np.clip(base + sign * noise, -(1 << 31), (1 << 31) - 1)
                     for sign in (1, -1)]).astype(np.int32)


def test_decode_32bit_mid_side_takes_the_wide_rule():
    """A frame with a 33-bit side restores in int64 in the port
    (decoder_fast.wide_frames), so its samples come back; flac_tpu's
    decode_frames_dp parses without `wide=` and restores such a frame in
    int32, which wraps the stereo undo (a difference kept on purpose)."""
    n = 1152
    pcm = _correlated(n * 3)
    data = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        1, sample_rate=96000, channels=2, bits_per_sample=32, blocksize=n),
        device="cpu")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    assert any(f["assignment"] == 3 for f in frames)       # mid-side
    np.testing.assert_array_equal(
        decode_frames_dp(data, st, frames, data_mesh(("cpu",) * 2)), pcm)
    rst, rpos = ref_parse_metadata(data, 4)
    ref = ref_shard.decode_frames_dp(data, rst, ref_scan_frames(
        data, rst, rpos), ref_shard.data_mesh(jax.devices()[:1]))
    assert not np.array_equal(ref, pcm)
