"""The compiled encode programs on a CUDA GPU (encoder._EncodePrograms):
each key's first call runs the ops, its second captures a CUDA graph, and
every call after that replays it, with K1 inside.

- replay against the ops (encoder._encode_batch_ops) for each key: the
  same words, byte lengths, bits and ok flags, also with several keys'
  graphs in one pool;
- the outputs of one replay outlive the next replay of the key;
- K1's counter moves by the launches the graph holds on each replay;
- a capture that fails raises, on every later call too: nothing falls
  back to the ops;
- a warm encode_batch makes no host sync (torch.cuda.set_sync_debug_mode);
- 6- and 8-channel batches (16 and 24 bits) through K10 (its channels
  passing through), K4 (its field layout past two channels) and K3 (six
  or eight subframes a frame) equal the plain versions, and their stream
  decodes back on the card.

Every test here carries the `gpu` marker and skips without a GPU (the
CPU side is tests/test_torch_encode_static.py).  The file imports neither
JAX nor flac_tpu:

    python -m pytest --noconftest -o addopts="" -p no:randomly \\
        tests/test_torch_compiled_cuda.py -m gpu
"""

import io

import numpy as np
import pytest
import torch

from flac_tpu_torch import EncoderConfig, decode_stream_tpu, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.decoder_fast import _parse_batch, restore_inputs
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac
from flac_tpu_torch.models import frame as frame_mod
from flac_tpu_torch.models import stereo
from flac_tpu_torch.ops import assemble_cuda, bitunpack, candidates_cuda, \
    pack_cuda, restore_cuda
from flac_tpu_torch.parallel.shard import encode_batch_sharded
from flac_tpu_torch.ref_decoder import parse_metadata

pytestmark = pytest.mark.gpu

N = 4096
B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs and K1 have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def programs(monkeypatch):
    """A fresh program cache for the test."""
    progs = encoder_mod._EncodePrograms()
    monkeypatch.setattr(encoder_mod, "_PROGRAMS", progs)
    return progs


def _blocks(seed, frames=B, bps=16, dtype=np.int32, channels=2):
    pcm = signals.make_test_signal(N * frames, channels, bps, seed=seed)
    return torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(channels, frames, N).transpose(1, 0, 2), dtype)).cuda()


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# (preset, channels, bits per sample, input dtype, layout)
KEYS = {
    "-0": (0, 2, 16, np.int32, "auto"),
    "-5 int16 input": (5, 2, 16, np.int16, "auto"),
    "-8": (8, 2, 16, np.int32, "auto"),
    "-5 safe layout": (5, 2, 16, np.int32, "safe"),
    "-5 24-bit (f64 residuals)": (5, 2, 24, np.int32, "auto"),
    "-8 24-bit (f64 residuals)": (8, 2, 24, np.int32, "auto"),
    "-5 24-bit 5.1": (5, 6, 24, np.int32, "auto"),
    "-5 32-bit (33-bit side)": (5, 2, 32, np.int32, "auto"),
}


@pytest.mark.parametrize("label", list(KEYS))
def test_replay_equals_the_ops(cuda, programs, label):
    level, channels, bps, dtype, layout = KEYS[label]
    cfg = EncoderConfig.from_preset(level, blocksize=N, channels=channels,
                                    bits_per_sample=bps).resolve()
    for call, seed in enumerate((1, 2, 3)):
        pcm = _blocks(seed, bps=bps, dtype=dtype, channels=channels)
        first = 100 * call
        got = encoder_mod.encode_batch(pcm, first, cfg, N, layout=layout)
        want = encoder_mod._encode_batch_ops(
            pcm, encoder_mod._frame_numbers(first, B, cuda), cfg, N, layout,
            "kernel")
        assert _same(got, want), f"call {call}"
        assert len(programs.graphs) == (0 if call == 0 else 1)


def test_trimmed_replay_equals_the_ops(cuda, programs):
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    fw = encoder_mod.default_fetch_words(N, 2, 16)
    for call, seed in enumerate((4, 5, 6)):
        pcm = _blocks(seed, frames=5, dtype=np.int16)
        main, rest = encoder_mod.encode_batch_trimmed(pcm, call * 5, cfg, N,
                                                      fw)
        want = encoder_mod._trim(encoder_mod._encode_batch_ops(
            pcm, encoder_mod._frame_numbers(call * 5, 5, cuda), cfg, N,
            "auto", "kernel"), fw)
        assert torch.equal(main, want[0]) and torch.equal(rest, want[1])
    assert len(programs.graphs) == 1


def test_per_frame_numbers_replay(cuda, programs):
    """The safe re-encode's [B] form: the numbers are a graph input."""
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    pcm = _blocks(7, frames=4)
    for call in range(3):
        nums = torch.tensor([9, 3, 70, 70], device=cuda) + call
        got = encoder_mod.encode_batch(pcm, nums - torch.arange(4,
                                                                device=cuda),
                                       cfg, N, layout="safe")
        want = encoder_mod._encode_batch_ops(pcm, nums, cfg, N, "safe",
                                             "kernel")
        assert _same(got, want)


def test_programs_of_a_device_share_a_pool(cuda, programs):
    """Two keys captured into one pool, then replayed in turns on other
    inputs: each replay still equals the ops."""
    cfgs = [EncoderConfig.from_preset(lv, blocksize=N).resolve()
            for lv in (0, 8)]
    for _ in range(2):                   # the ops, then the capture
        for cfg in cfgs:
            encoder_mod.encode_batch(_blocks(16), 0, cfg, N)
    assert len(programs.graphs) == 2 and len(programs.pools) == 1
    for seed in (17, 18, 19):
        for cfg in cfgs:
            pcm = _blocks(seed)
            got = encoder_mod.encode_batch(pcm, seed, cfg, N)
            want = encoder_mod._encode_batch_ops(
                pcm, encoder_mod._frame_numbers(seed, B, cuda), cfg, N,
                "auto", "kernel")
            assert _same(got, want)


def test_outputs_outlive_the_next_replay(cuda, programs):
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    a, b = _blocks(11), _blocks(12)
    for _ in range(2):                   # the ops, then the capture
        encoder_mod.encode_batch(a, 0, cfg, N)
    first = encoder_mod.encode_batch(a, 0, cfg, N)
    kept = [t.clone() for t in first]
    second = encoder_mod.encode_batch(b, 0, cfg, N)
    torch.cuda.synchronize()
    assert _same(first, kept)
    assert not torch.equal(first.words, second.words)


def test_k1_counter_moves_on_each_replay(cuda, programs):
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    pcm = _blocks(13)
    steps = []
    for _ in range(4):
        launches, captured = pack_cuda.launches, pack_cuda.captured
        encoder_mod.encode_batch(pcm, 0, cfg, N)
        steps.append((pack_cuda.launches - launches,
                      pack_cuda.captured - captured))
    # the ops launch K1; the capture records it and replays; replays
    assert steps == [(1, 0), (1, 1), (1, 0), (1, 0)]
    [prog] = programs.graphs.values()
    assert prog.kernel_launches["pack_fields64"] == 1 and prog.pool_bytes > 0
    encoder_mod.encode_batch(pcm, 0, cfg, N, layout="safe")
    launches = pack_cuda.launches
    encoder_mod.encode_batch(pcm, 0, cfg, N, layout="safe")
    encoder_mod.encode_batch(pcm, 0, cfg, N, layout="safe")
    assert pack_cuda.launches == launches          # no K1 in the safe layout


def test_warm_encode_makes_no_host_sync(cuda, programs):
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    pcm = _blocks(14, dtype=np.int16)
    for _ in range(2):
        encoder_mod.encode_batch(pcm, 0, cfg, N)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        encoder_mod.encode_batch(pcm, 0, cfg, N)
        encoder_mod._encode_batch_ops(
            pcm, encoder_mod._frame_numbers(0, B, cuda), cfg, N, "auto",
            "kernel")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_stream_encoder_and_shards_replay(cuda, programs):
    """StreamEncoder's batches and four shard entries of the card go
    through the graphs: one key each, the shards' bytes equal the ops'."""
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    pcm = signals.make_test_signal(N * 4 * B + 100, seed=15)
    out = io.BytesIO()
    with StreamEncoder(out, cfg, batch_frames=B, device=cuda) as enc:
        enc.process(pcm)
        enc.finish()
    names = [k[0][0] for k in programs.graphs]
    assert names == ["encode_batch"]               # 4 batches: one key
    blocks = pcm[:, :N * 4 * B].reshape(2, 4 * B, N).transpose(1, 0, 2)
    for _ in range(2):
        shards = encode_batch_sharded(blocks, 0, cfg, N, [cuda] * 4)
    want = encoder_mod._encode_batch_ops(
        torch.from_numpy(np.ascontiguousarray(blocks)).cuda(),
        encoder_mod._frame_numbers(0, 4 * B, cuda), cfg, N, "auto",
        "kernel")
    assert torch.equal(torch.cat([s.words for s in shards]), want.words)
    assert torch.equal(torch.cat([s.byte_len for s in shards]),
                       want.byte_len)


@pytest.mark.parametrize("fault", ["host sync", "exception"])
def test_a_failed_capture_raises(cuda, programs, fault):
    x = torch.arange(16, device=cuda)
    stream = torch.cuda.current_stream()

    def fn(t):
        if fault == "host sync":
            return (t * int(t.sum()),)              # .item() in a capture
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("capture broke")
        return (t * 2,)
    assert torch.equal(programs.run("fault", fn, x)[0], x * (
        int(x.sum()) if fault == "host sync" else 2))
    for _ in range(2):                     # every later call raises too
        with pytest.raises((RuntimeError, ValueError)):
            programs.run("fault", fn, x)
        assert not programs.graphs
        assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.arange(1, 17, device=cuda))


def _same_outputs(got, want):
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("channels", [6, 8])
def test_multichannel_batches_match_plain(cuda, programs, monkeypatch,
                                          channels, bps):
    """K10, K4 and K3 take 6- and 8-channel batches: K10 passes each
    channel through in a CTA of its own, K4 lays out the fields of every
    channel, K3 restores six or eight subframes a frame.  Each equals its
    plain version; the stream decodes back on the card."""
    cfg = EncoderConfig.from_preset(5, blocksize=N, channels=channels,
                                    bits_per_sample=bps).resolve()
    pcm = _blocks(20 + channels, bps=bps, channels=channels,
                  dtype=np.int16 if bps <= 16 else np.int32)
    launched = candidates_cuda.launches
    got = stereo.build_channel_candidates(pcm, cfg)
    assert candidates_cuda.launches == launched + 1
    assert _same_outputs(got, stereo.build_channel_candidates_plain(pcm,
                                                                    cfg))
    seen = {}
    real = frame_mod.assemble_fields

    def spy(*args):
        seen["k4"] = args
        return real(*args)
    monkeypatch.setattr(frame_mod, "assemble_fields", spy)
    encoder_mod._encode_batch_ops(pcm, encoder_mod._frame_numbers(0, B, cuda),
                                  cfg, N, "auto", "kernel")
    monkeypatch.undo()
    launched = assemble_cuda.launches
    got = frame_mod.assemble_fields(*seen["k4"])
    assert assemble_cuda.launches == launched + 1
    assert _same_outputs(got, frame_mod.assemble_fields_plain(*seen["k4"]))
    # K3 on the first parsed batch of the card's stream of these blocks
    host = pcm.cpu().numpy().transpose(1, 0, 2).reshape(channels, -1)
    data = encode_file_to_flac(host.astype(np.int32), cfg, device=cuda,
                               batch_frames=B)
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    pg, asg = _parse_batch(np.frombuffer(data, np.uint8), frames,
                           list(range(len(frames))), N, channels)
    arrays, kw = restore_inputs(pg, asg, N, channels, bps)
    for res in (arrays[0], arrays[0].astype(np.int32)):
        t = [torch.from_numpy(a).to(cuda) for a in (res, *arrays[1:])]
        args = (t[0][:, :N], *t[1:])
        k = dict(kw, out16=kw["out16"] and res.dtype == np.int16)
        launched = restore_cuda.launches
        got = restore_cuda.restore_undo(*args, **k)
        assert restore_cuda.launches == launched + 1
        assert _same_outputs(got, bitunpack.restore_undo_body(*args, **k))
    back = decode_stream_tpu(data, engine="device")
    assert back.md5_ok and np.array_equal(back.samples, host)
