"""StreamEncoder's in-flight pipeline (pipeline_depth, super_batches) in
flac_tpu_torch against flac_tpu's, on the CPU.

The bytes do not depend on the options, and at -1 they are flac_tpu's with
the same options, as are the progress calls (once a written super-chunk
or batch).  A noise frame past default_fetch_words takes the remainder
fetch, a misfit frame inside a super-chunk is re-encoded with its own
frame number, and an error on the MD5 worker is raised at finish().

Every encode has the same shape (blocksize 1024, batches of 4, 22 full
frames and a 300-sample tail), so flac_tpu compiles three batch shapes.
"""

import io

import numpy as np
import pytest
import torch

import flac_tpu
from flac_tpu.encoder import StreamEncoder as RefEncoder
from flac_tpu_torch import EncoderConfig, native
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.encoder import StreamEncoder, default_fetch_words
from flac_tpu_torch.decoder import scan_frames
from flac_tpu_torch.ref_decoder import decode_stream, parse_metadata

from conftest import make_test_signal

torch.set_num_threads(1)

N = 1024
BATCH = 4
N_SAMPLES = N * 22 + 300
PCM = make_test_signal(N_SAMPLES, seed=21)


def _encode(cls, cfg_cls, pcm, **kw):
    buf = io.BytesIO()
    calls = []
    with cls(buf, cfg_cls.from_preset(1, blocksize=N), batch_frames=BATCH,
             progress_callback=lambda *a: calls.append(a), **kw) as enc:
        enc.process(pcm)
        enc.finish()
    return buf.getvalue(), calls, enc


def _port(pcm=PCM, **kw):
    return _encode(StreamEncoder, EncoderConfig, pcm, device="cpu", **kw)


def _ref(pcm=PCM, **kw):
    return _encode(RefEncoder, flac_tpu.EncoderConfig, pcm, **kw)


@pytest.fixture(scope="module")
def default_stream():
    return _port()[0]


@pytest.mark.parametrize("super_batches", [1, 3, 8])
@pytest.mark.parametrize("pipeline_depth", [1, 2, 6])
def test_bytes_and_progress_match_flac_tpu(pipeline_depth, super_batches,
                                           default_stream):
    """The same bytes at every depth and super-chunk size, flac_tpu's bytes
    and progress calls with the same options; one call a written unit."""
    kw = dict(pipeline_depth=pipeline_depth, super_batches=super_batches)
    ours, calls, enc = _port(**kw)
    ref, ref_calls, _ = _ref(**kw)
    assert ours == ref == default_stream
    assert calls == ref_calls
    # super-chunks of up to super_batches batches while 4 or more full
    # frames are buffered, then the trimmed batch of 2 and the tail
    done, left = [], 22
    while left >= BATCH:
        take = min(left // BATCH, super_batches) * BATCH
        done.append(22 - left + take)
        left -= take
    assert [c[0] for c in calls] == done + [22, 23]
    assert enc.remainder_fetches == 0 and enc.misfit_frames == 0


def test_noise_frame_takes_the_remainder_fetch():
    """A noise frame in the trimmed batch compresses past
    default_fetch_words: its remainder words are fetched, and the bytes
    are still flac_tpu's.  (At full scale the frame is verbatim, a quad
    misfit that the safe re-encode replaces without the fetch.)"""
    pcm = PCM.copy()
    rng = np.random.default_rng(5)
    pcm[:, 21 * N:22 * N] = rng.integers(-12000, 12000, (2, N))
    ours, _, enc = _port(pcm)
    ref, _, _ = _ref(pcm)
    assert ours == ref
    assert enc.remainder_fetches == 1 and enc.misfit_frames == 0
    fw = default_fetch_words(N, 2, 16)
    assert max(len(f) for f in _frames(ours)) > 4 * fw
    np.testing.assert_array_equal(decode_stream(ours).samples, pcm)


def _frames(stream):
    st, pos = parse_metadata(stream, 4)
    return [stream[f["offset"]:f["offset"] + f["size"]]
            for f in scan_frames(stream, st, pos)]


def test_misfit_inside_a_super_chunk(monkeypatch, default_stream):
    """A frame of the second batch of a super-chunk flagged as a quad
    misfit (its words and length garbage) is re-encoded with the safe
    layout and its absolute frame number: the stream is unchanged."""
    real = encoder_mod.encode_batch

    def flag_one(pcm, first, cfg, blocksize, layout="auto", **kw):
        pf = real(pcm, first, cfg, blocksize, layout=layout, **kw)
        if layout == "auto" and isinstance(first, int) and first == BATCH:
            ok, lens, words = pf.ok.clone(), pf.byte_len.clone(), \
                pf.words.clone()
            ok[1], lens[1], words[1] = False, 5, 0
            pf = pf._replace(ok=ok, byte_len=lens, words=words)
        return pf
    monkeypatch.setattr(encoder_mod, "encode_batch", flag_one)
    ours, _, enc = _port(super_batches=3)
    assert enc.misfit_frames == 1
    assert ours == default_stream


def test_md5_worker_error_is_raised_at_finish(monkeypatch):
    def broken(self, pcm, bps):
        raise ValueError("md5 worker broke")
    monkeypatch.setattr(native.MD5, "update_pcm", broken)
    enc = StreamEncoder(io.BytesIO(), EncoderConfig.from_preset(
        0, blocksize=N), batch_frames=BATCH, device="cpu")
    enc.process(PCM)
    with pytest.raises(ValueError, match="md5 worker broke"):
        enc.finish()
    assert not enc._md5_thread.is_alive()
    enc.close()


def test_close_stops_the_worker_with_batches_in_flight():
    enc = StreamEncoder(io.BytesIO(), EncoderConfig.from_preset(
        0, blocksize=N), batch_frames=BATCH, device="cpu")
    enc.process(PCM)
    assert enc._inflight
    enc.close()
    assert not enc._md5_thread.is_alive() and not enc._inflight


def test_verify_error_in_process_stops_the_worker(monkeypatch):
    """A verify mismatch raised from process() (a super-chunk drained
    while later ones are queued) closes the encoder: its MD5 worker and
    the work in flight are gone, and later calls raise."""
    def wrong(blob, st, frames, device=None):
        return [np.zeros((2, f["blocksize"]), np.int32) for f in frames]
    monkeypatch.setattr(encoder_mod, "decode_frame_list", wrong)
    enc = StreamEncoder(io.BytesIO(), EncoderConfig.from_preset(
        0, blocksize=N), batch_frames=BATCH, device="cpu", verify=True,
        pipeline_depth=1, super_batches=1)
    with pytest.raises(RuntimeError, match="verify mismatch"):
        enc.process(PCM)
    assert not enc._md5_thread.is_alive() and not enc._inflight
    with pytest.raises(RuntimeError, match="closed"):
        enc.finish()


def test_dropped_encoder_stops_its_worker():
    """An encoder dropped with batches in flight, neither finished nor
    closed, is collected, and its MD5 worker stops."""
    import gc
    enc = StreamEncoder(io.BytesIO(), EncoderConfig.from_preset(
        0, blocksize=N), batch_frames=BATCH, device="cpu")
    enc.process(PCM)
    thread = enc._md5_thread
    assert thread.is_alive()
    del enc
    gc.collect()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_md5_worker_keeps_order_under_many_small_calls():
    """Hundreds of 97-sample process() calls from one reused buffer, with
    the interpreter switching threads as often as it can: the STREAMINFO
    MD5 is the source's (the worker hashes in order, and hashes a copy of
    what the caller passed, not the caller's refilled buffer)."""
    import hashlib
    import sys

    from flac_tpu_torch.encoder import interleave_for_md5
    step = 97
    chunk = np.empty((2, step), np.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        buf = io.BytesIO()
        with StreamEncoder(buf, EncoderConfig.from_preset(0, blocksize=N),
                           batch_frames=BATCH, device="cpu") as enc:
            for a in range(0, N_SAMPLES, step):
                part = PCM[:, a:a + step]
                if part.shape[1] < step:
                    enc.process(part.copy())
                    break
                chunk[:] = part
                enc.process(chunk)
                chunk[:] = 0                # the caller refills its buffer
            info = enc.finish()
    finally:
        sys.setswitchinterval(old)
    assert info.md5 == hashlib.md5(interleave_for_md5(PCM, 16)).digest()
    np.testing.assert_array_equal(
        decode_stream(buf.getvalue(), verify_md5=True).samples, PCM)
