"""Stream encoder: the batched device pipeline + host-side stream assembly.

Port of flac_tpu/encoder.py.

  [B, C, N] int16 or int32 PCM blocks on the device
      -> stereo candidates + wasted bits        (models/stereo.py: K10)
      -> exact candidate grid search + realize  (models/subframe.py: K11
                                                 the windowed
                                                 autocorrelation, K6 the
                                                 LPC coefficients, K8 the
                                                 residuals, K7 the Rice
                                                 costs, K9 the select and
                                                 realize)
      -> channel assignment argmin + gathers    (models/stereo.py: K12)
      -> field lists, bit-pack, CRCs            (models/frame.py: K4, K1,
                                                 K5)
      -> [B, W] packed words + lengths

StreamEncoder keeps batches in flight on the device while it writes
earlier ones in order (options `pipeline_depth=6`, `super_batches=8`, as
the reference's): full batches go out in super-chunks whose words stay on
the device until one copy of their trimmed rows, other batches through
encode_batch_trimmed; 16-bit sources upload as int16; the copies are
`non_blocking` into pinned memory behind CUDA events; the MD5 runs on a
worker thread.  The STREAMINFO block is back-patched at finish exactly
like update_metadata_ (stream_encoder.c:3139-3300), with the seek table
resolved to real frame positions.  With verify=True each written
super-chunk or batch is decoded back on the device (the "device" engine:
K2, then K3) and compared with its input before a byte of it is written.

On a CUDA device encode_batch and encode_batch_trimmed run as compiled
programs, the counterpart of the reference's jitted ones: a CUDA graph for
each static key (configuration, shapes, dtypes, layout, packer), captured
on the key's second call and replayed after that, with K10, K11, K6, K8,
K7, K9, K12, K4, K1 and K5 inside (_EncodePrograms).  The ops they
capture read nothing back from the device and copy no constant from host
memory on a warm call.

The ops mark their stages as profiler ranges (flac.candidates;
flac.search, with flac.lpc_coeffs, flac.residuals, flac.rice and
flac.select inside search_and_realize; flac.assign; flac.assemble, with
flac.fields, flac.pack and flac.seal inside assemble_frames): a few
microseconds of host time each while torch.profiler is not recording.
A graph replay records no range: its kernels show up in a trace on their
own.
"""

from __future__ import annotations

import bisect
import functools
import io
import queue
import struct
import threading
import time
import weakref

import numpy as np
import torch
from torch.profiler import record_function

from . import format as fmt
from . import native
from .config import EncoderConfig
from .decoder import decode_frame_list, parse_frame_header
from .device import resolve_device
from .metadata import SeekPoint
from .models import frame as frame_mod
from .models import stereo as stereo_mod
from .models import subframe as subframe_mod
from .ops import assemble_cuda, assign_cuda, autoc_cuda, candidates_cuda, \
    lpc_cuda, pack_cuda, residuals_cuda, rice_cost_cuda, seal_cuda, \
    select_cuda
from .ops import lpc as lpc_ops
from .ref_decoder import DecodedStream, FlacDecodeError
from .utils.bits import BitWriter


@functools.lru_cache(maxsize=None)
def _bank_for(cfg: EncoderConfig, blocksize: int):
    return lpc_ops.build_apodization_bank(blocksize, cfg.apodizations)


# the wrappers of the kernels an encode program launches, by kernel name:
# each counts a launch recorded during a capture in `captured` and takes a
# replay's launches through `count_replay`
COUNTED_KERNELS = {"channel_candidates": candidates_cuda,
                   "window_autoc": autoc_cuda,
                   "lpc_coeffs": lpc_cuda,
                   "candidate_residuals": residuals_cuda,
                   "rice_cost": rice_cost_cuda,
                   "select_realize": select_cuda,
                   "pack_fields64": pack_cuda,
                   "assemble_fields": assemble_cuda,
                   "frame_crc": seal_cuda,
                   "assign_channels": assign_cuda}


class _CapturedProgram:
    """One compiled encode program: a CUDA graph with static input
    buffers, its intermediates and outputs in the programs' memory pool
    (see _EncodePrograms).  `kernel_launches`: the launches of each kernel
    of COUNTED_KERNELS that the graph holds."""

    __slots__ = ("graph", "inputs", "outputs", "kernel_launches",
                 "capture_ms", "pool_bytes")

    def __init__(self, fn, inputs, pool):
        dev = inputs[0].device
        # static inputs, allocated outside the pool
        self.inputs = tuple(t.clone() for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph synchronizes and empties the cache before it
        # captures (on a side stream of its own); do it here first so the
        # reserved bytes before and after count what the capture adds to
        # the pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = {k: m.captured for k, m in COUNTED_KERNELS.items()}
        stream = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(*self.inputs)
        finally:
            # a capture that fails on a CUDA error leaves torch.cuda.graph's
            # side stream current (its __exit__ raises before restoring it)
            torch.cuda.set_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.kernel_launches = {k: m.captured - before[k]
                                for k, m in COUNTED_KERNELS.items()}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        for k, m in COUNTED_KERNELS.items():
            m.count_replay(self.kernel_launches[k])
        # the next replay overwrites the static outputs, while callers keep
        # several batches' words on the device (_SuperJob, _BatchJob, the
        # shards): copy them out, on the same stream
        out = [t.clone() for t in self.outputs]
        return (self.outputs._make(out) if hasattr(self.outputs, "_make")
                else tuple(out))


class _EncodePrograms:
    """The compiled encode programs: the counterpart of the reference's
    jitted encode_batch family (flac_tpu/encoder.py:46-149), which is
    compiled once per static key and then only replayed.

    On a CUDA tensor, `run(name, fn, *inputs)` keeps one CUDA graph per
    key (name, with the configuration's static arguments, and each input's
    device, shape and dtype):
    - the first call of a key runs `fn` op by op, so a one-off shape (a
      stream's final block) pays no capture; that call is also the warm-up
      a capture needs (K1's probe and attribute set, the kernels'
      libraries and K5's tables, cuBLAS's handle);
    - the second call captures `fn` into a graph (torch.cuda.graph, on a
      side stream) and replays it; every later call copies its inputs into
      the graph's static buffers and replays;
    - a capture or a replay that fails raises: nothing falls back to the
      ops;
    - each replay's outputs are copied out on the stream (see
      _CapturedProgram.replay).
    The graphs of a device share one memory pool: a graph's intermediates
    are dead outside its replay, so the pool holds the largest graph's
    and every graph's static outputs, not the sum of their
    intermediates.  That, and each graph's own static buffers, need its
    replays to run one at a time: on the caller's current stream, from
    one thread (a capture from another thread would fail anyway).
    On the CPU `fn` runs op by op, as before.
    """

    def __init__(self):
        self.seen: set = set()       # keys whose first call ran the ops
        self.graphs: dict = {}       # key -> _CapturedProgram
        self.pools: dict = {}        # device -> graph memory pool handle

    def run(self, name, fn, *inputs):
        dev = inputs[0].device
        if dev.type != "cuda":
            return fn(*inputs)
        key = (name, tuple((t.device, tuple(t.shape), t.dtype)
                           for t in inputs))
        with torch.cuda.device(dev):
            prog = self.graphs.get(key)
            if prog is None:
                if key not in self.seen:
                    self.seen.add(key)
                    return fn(*inputs)
                if dev not in self.pools:
                    self.pools[dev] = torch.cuda.graph_pool_handle()
                prog = self.graphs[key] = _CapturedProgram(
                    fn, inputs, self.pools[dev])
            return prog.replay(inputs)

    def clear(self):
        """Drop every graph, their pools and every key seen."""
        self.seen.clear()
        self.graphs.clear()
        self.pools.clear()


_PROGRAMS = _EncodePrograms()


def _frame_numbers(first_frame_number, B: int, device) -> torch.Tensor:
    """[B] int64 frame numbers first_frame_number + arange(B), built on
    the device: an int goes in as a kernel argument, a [B] tensor gives
    each frame its own base."""
    numbers = torch.arange(B, dtype=torch.int64, device=device)
    if isinstance(first_frame_number, torch.Tensor):
        return numbers + first_frame_number.to(device, torch.int64)
    return numbers + int(first_frame_number)


def _encode_batch_ops(pcm, frame_numbers, cfg: EncoderConfig,
                      blocksize: int, layout: str,
                      packer: str) -> frame_mod.PackedFrames:
    """encode_batch op by op: the program that the compiled form captures,
    and the form that runs on the CPU.  frame_numbers: [B] int64 on pcm's
    device.  Reads nothing back from the device and copies nothing from
    host memory once its constants are on the device (device.constant)."""
    if pcm.dtype not in (torch.int16, torch.int32):
        pcm = pcm.to(torch.int32)      # K10 reads int16 and int32 as they are
    bank = _bank_for(cfg, blocksize)
    with record_function("flac.candidates"):
        x, bps_eff, wasted, *loose = stereo_mod.build_channel_candidates(
            pcm, cfg)
    with record_function("flac.search"):
        choice = subframe_mod.search_and_realize(x, bps_eff, wasted, cfg,
                                                 bank)
    with record_function("flac.assign"):
        assignment, choice, signal = stereo_mod.assign_channels(
            choice, x, loose[0] if loose else None, cfg,
            pcm.shape[1] == 2 and cfg.do_mid_side)
    with record_function("flac.assemble"):
        return frame_mod.assemble_frames(choice, signal, assignment,
                                         frame_numbers, cfg, blocksize,
                                         layout=layout, packer=packer)


def encode_batch(pcm, first_frame_number, cfg: EncoderConfig,
                 blocksize: int, layout: str = "auto",
                 packer: str = "kernel") -> frame_mod.PackedFrames:
    """Encode a batch of equal-size blocks into packed FLAC frames.

    pcm: [B, C, N] int32 tensor (N == blocksize) on the encoding device;
        int16 is widened on the device, inside the program (K10 reads it
        as it is)
    first_frame_number: int, or [B] int64 tensor — frame index of pcm[0]
        (the frames are numbered first_frame_number + arange(B))
    cfg: a resolved EncoderConfig
    layout: frame.assemble_frames pack layout ("auto" = fused-quad when
        eligible; frames it can't represent come back ok=False and are
        re-encoded with layout="safe" — see StreamEncoder._write_frames).
    packer: the quad-layout deposit, see frame.assemble_frames.

    On a CUDA tensor it runs as a compiled program (_EncodePrograms: a
    CUDA graph a static key, captured on the key's second call); on the
    CPU op by op.
    """
    return _PROGRAMS.run(
        ("encode_batch", cfg, blocksize, layout, packer),
        functools.partial(_encode_batch_ops, cfg=cfg, blocksize=blocksize,
                          layout=layout, packer=packer),
        pcm, _frame_numbers(first_frame_number, pcm.shape[0], pcm.device))


def _flag_lens(byte_len, ok):
    """Mark quad-layout misfit frames with bit 30 of the fetched length."""
    return torch.where(ok, byte_len, byte_len | (1 << 30))


def _trim(packed: frame_mod.PackedFrames, fetch_words: int):
    fw = min(fetch_words, packed.words.shape[1])
    main = torch.cat([_flag_lens(packed.byte_len, packed.ok)[:, None],
                      packed.words[:, :fw].to(torch.int32)], dim=1)
    return main, packed.words[:, fw:]


def encode_batch_trimmed(pcm, first_frame_number, cfg: EncoderConfig,
                         blocksize: int, fetch_words: int,
                         packer: str = "kernel"):
    """encode_batch shaped for a small device-to-host copy.

    The padded power-of-two word rows bound ~3x the compressed size, so
    the rows are split at `fetch_words` (sized to cover typical compressed
    frames): the host always fetches `main`, each frame's byte length in
    column 0 (bit 30 flags a quad-layout misfit) and then its first
    fetch_words words, and touches `rest` only for a frame that compressed
    past the trim point.

    pcm: [B, C, N] integer blocks (int16 is widened on the device).
    Returns (main [B, 1 + fetch_words] int32, rest [B, W - fetch_words]
    int64), both holding uint32 words.  On a CUDA tensor the encode and
    the split are one compiled program of their own (see encode_batch);
    on the CPU it is encode_batch, then the split.
    """
    if pcm.device.type != "cuda":
        return _trim(encode_batch(pcm, first_frame_number, cfg, blocksize,
                                  packer=packer), fetch_words)

    def program(p, numbers):
        return _trim(_encode_batch_ops(p, numbers, cfg, blocksize, "auto",
                                       packer), fetch_words)
    return _PROGRAMS.run(
        ("encode_batch_trimmed", cfg, blocksize, fetch_words, packer),
        program, pcm,
        _frame_numbers(first_frame_number, pcm.shape[0], pcm.device))


def default_fetch_words(N: int, C: int, bps: int) -> int:
    """Trim point for encode_batch_trimmed: generous against typical
    compression (~0.5-0.8 of raw for real audio) so remainder fetches stay
    rare, far below the power-of-two padded worst case."""
    raw_words = (N * C * bps + 31) // 32
    return (raw_words * 7) // 8 + 64


def _md5_bytes_per_sample(bps: int) -> int:
    return (bps + 7) // 8


def interleave_for_md5(pcm: np.ndarray, bps: int) -> bytes:
    """Interleave [C, N] int32 -> little-endian signed bytes/sample stream
    (FLAC__MD5Accumulate, md5.c:388-520)."""
    C, N = pcm.shape
    nb = _md5_bytes_per_sample(bps)
    inter = np.ascontiguousarray(pcm.T.astype(np.int32))   # [N, C]
    if nb == 4:
        return inter.tobytes()
    le = inter.astype("<i4").view(np.uint8).reshape(N, C, 4)
    return np.ascontiguousarray(le[:, :, :nb]).tobytes()


def _md5_worker(q: queue.Queue, md5, bps: int, errors: list):
    """The MD5 fifo (the reference's md5_fifo, stream_encoder.c:
    3575-3686): hashing never holds up the device work.  The first error
    goes into `errors`, raised at finish().  It holds no reference to its
    encoder, so an encoder dropped unfinished is collected and its worker
    stopped (StreamEncoder._stop_md5)."""
    while True:
        pcm = q.get()
        if pcm is None:
            return
        try:
            md5.update_pcm(pcm, bps)
        except Exception as e:
            if not errors:
                errors.append(e)


def _stop_md5_worker(q: queue.Queue, thread: threading.Thread):
    if thread.is_alive():
        q.put(None)
        thread.join()


class StreamInfo:
    """STREAMINFO metadata block (format.h:536-544)."""

    def __init__(self, cfg: EncoderConfig):
        self.min_blocksize = cfg.blocksize
        self.max_blocksize = cfg.blocksize
        self.min_framesize = (1 << 24) - 1
        self.max_framesize = 0
        self.sample_rate = cfg.sample_rate
        self.channels = cfg.channels
        self.bits_per_sample = cfg.bits_per_sample
        self.total_samples = 0
        self.md5 = b"\x00" * 16

    def to_bytes(self) -> bytes:
        bw = BitWriter()
        bw.write(self.min_blocksize, 16)
        bw.write(self.max_blocksize, 16)
        bw.write(self.min_framesize if self.max_framesize else 0, 24)
        bw.write(self.max_framesize, 24)
        bw.write(self.sample_rate, 20)
        bw.write(self.channels - 1, 3)
        bw.write(self.bits_per_sample - 1, 5)
        bw.write(self.total_samples, 36)
        bw.write_bytes(self.md5)
        return bw.getvalue()


def metadata_block_header(block_type: int, length: int,
                          is_last: bool) -> bytes:
    return struct.pack(">I", ((1 if is_last else 0) << 31)
                       | (block_type << 24) | length)


def _big_endian_rows(words: np.ndarray) -> np.ndarray:
    """[B, K] host words (uint32 bits) -> [B, 4*K] big-endian bytes."""
    return words.view(np.uint32).astype(">u4").view(np.uint8).reshape(
        words.shape[0], -1)


def _words_to_wbytes(words: torch.Tensor, ncols: int) -> np.ndarray:
    """[B, W] int64 device words -> [B, 4*ncols] big-endian host bytes."""
    return _big_endian_rows(words[:, :ncols].to(torch.int32).cpu().numpy())


class _HostCopy:
    """A device-to-host copy in flight: `non_blocking` into pinned host
    memory, an event recorded after it (the counterpart of the reference's
    copy_to_host_async and fetch pool).  A CPU tensor needs no copy."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type != "cuda":
            self.host = t
            return
        # a fresh pinned buffer each copy: the caching host allocator hands
        # its memory out again only after the event of the copy that used
        # it has passed, so no buffer is reused while a copy is in flight
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _BatchJob:
    """A batch in flight through the trimmed fetch (encode_batch_trimmed):
    `main` on its way to the host, `rest` kept on the device."""

    __slots__ = ("main", "rest", "blocks", "mb", "N", "base")

    def __init__(self, main, rest, blocks, N, base):
        self.main = _HostCopy(main)
        self.rest = rest
        self.blocks = blocks
        self.mb = blocks.shape[0]
        self.N = N
        self.base = base

    def poll(self):
        pass


class _SuperJob:
    """A super-chunk in flight: the padded word rows of its batches stay on
    the device while their flagged byte lengths come back; once those have
    landed, one copy brings back every batch's rows cut to the 256-word
    bucket over the longest frame, about the compressed bytes."""

    __slots__ = ("words_list", "lens_copy", "lens", "bad", "slice_copy",
                 "blocks", "mb", "N", "base")

    def __init__(self, words_list, lens, blocks, N, base):
        self.words_list = words_list
        self.lens_copy = _HostCopy(lens)
        self.lens = self.bad = self.slice_copy = None
        self.blocks = blocks
        self.mb = blocks.shape[0]
        self.N = N
        self.base = base

    def poll(self):
        """Start the slice copy as soon as the lengths are on the host."""
        if self.slice_copy is None and self.lens_copy.done():
            self._start_slice()

    def _start_slice(self):
        lens = self.lens_copy.wait().astype(np.int64)
        self.bad = lens >= (1 << 30)            # quad-layout misfit flags
        # a misfit frame's length is not its real one: size the copy by
        # the frames that are kept, and let the safe re-encode set the rest
        self.lens = np.where(self.bad, 0, lens & ((1 << 30) - 1))
        kw = (int(self.lens.max()) + 3) // 4
        kb = min(-(-kw // 256) * 256, self.words_list[0].shape[1])
        self.slice_copy = _HostCopy(torch.cat(
            [w[:, :kb] for w in self.words_list]).to(torch.int32))
        self.words_list = None            # release the padded device rows

    def wait(self):
        if self.slice_copy is None:
            self._start_slice()
        return self.slice_copy.wait(), self.lens


class StreamEncoder:
    """Host-side streaming encoder: buffers PCM, encodes batches of
    `batch_frames` frames on the device, writes the byte stream in order,
    back-patches STREAMINFO (and the seek table) at finish.

    The emit path is a pipeline (the reference's worker pool, ordered
    bitbuffer drain and md5_fifo, stream_encoder.c:3490-3686):
    - full batches go out in super-chunks of up to `super_batches`
      batches: each batch's words stay on the device, the flagged byte
      lengths come back first, then one copy of every batch's rows cut to
      the longest frame (_SuperJob);
    - other batches (the tail, the final short block) take the trimmed
      fetch: the lengths and each frame's first default_fetch_words words
      come back, the rest only for a frame that passed the trim point
      (`remainder_fetches` counts those);
    - sources of 16 bits or fewer upload as int16 and widen on the device;
    - up to `pipeline_depth` batches, and max(2, pipeline_depth)
      super-chunks, are in flight while earlier ones are written, in
      order; the copies are `non_blocking` into pinned host memory, each
      followed by a CUDA event;
    - the MD5 runs on a worker thread (native.MD5.update_pcm); an error
      there is raised at finish().  The worker stops at finish(), at
      close(), on an error raised from process() or finish() (which close
      the encoder), or when an unfinished encoder is collected.
    The bytes do not depend on pipeline_depth or super_batches.  verify,
    the progress callback and the seek-table index run once for each
    written super-chunk or batch.

    device: None means "cuda" (raises if no GPU is present); pass "cpu" to
    run on the CPU.  packer: the quad-layout deposit ("kernel" or
    "plain"), see models/frame.assemble_frames.
    extra_metadata: raw (type, body) blocks written after STREAMINFO and the
    seek table, before the padding.  seektable: a metadata.SeekTableBlock
    template (template_spaced, template_count, placeholders), resolved to
    real frame positions at finish.  verify: decode every written unit on
    the device (decoder.decode_frame_list, the "device" engine) and compare
    it sample for sample with the input before a byte of it is written.
    progress_callback(frames_done, blocksize, bytes_written) runs after
    each written unit.  An `out` with a `write_frames` method (the Ogg
    sink, ogg.OggFlacSink) takes each unit with its frame lengths.
    """

    def __init__(self, out, cfg: EncoderConfig, *, batch_frames: int = 64,
                 padding: int = 4096, device=None, packer: str = "kernel",
                 extra_metadata: list | None = None, seektable=None,
                 verify: bool = False, pipeline_depth: int = 6,
                 super_batches: int = 8, progress_callback=None):
        self.out = out
        self.cfg = cfg.resolve()
        self.device = resolve_device(device)
        self.packer = packer
        self.batch_frames = batch_frames
        self.verify = verify
        self.blocksize = self.cfg.blocksize
        self._buf = np.zeros((self.cfg.channels, 0), np.int32)
        self._frame_number = 0
        self._info = StreamInfo(self.cfg)
        self._header_pos = None
        self._seektable = seektable       # SeekTableBlock template or None
        self._seektable_pos = None        # file offset of its body
        self._frame_index = []            # (first_sample, offset, blocksize)
        self._first_frame_offset = None
        self._pipeline_depth = max(1, pipeline_depth)
        self._super_batches = max(1, super_batches)
        # super-chunks in flight: each holds super_batches batches' word
        # rows on the device
        self._super_depth = max(2, self._pipeline_depth)
        self._inflight = []               # FIFO of _BatchJob / _SuperJob
        self._progress = progress_callback
        self._bytes_written = 0
        self._closed = False
        self.misfit_frames = 0    # quad-layout misfits re-encoded "safe"
        self.remainder_fetches = 0   # trimmed fetches past the trim point
        self._write_stream_header(padding, extra_metadata or [])
        self._md5 = native.MD5()
        self._md5_errors = []
        self._md5_queue = queue.Queue(maxsize=8)
        self._md5_thread = threading.Thread(
            target=_md5_worker, daemon=True,
            args=(self._md5_queue, self._md5, self.cfg.bits_per_sample,
                  self._md5_errors))
        self._md5_thread.start()
        # stops the worker once: at finish(), close(), an error in
        # process() or finish(), or when the encoder is collected
        self._stop_md5 = weakref.finalize(self, _stop_md5_worker,
                                          self._md5_queue, self._md5_thread)

    def _write_stream_header(self, padding: int, extra: list):
        self.out.write(fmt.STREAM_SYNC_STRING)
        self._header_pos = self.out.tell()
        si = self._info.to_bytes()
        is_last = padding <= 0 and not extra and self._seektable is None
        self.out.write(metadata_block_header(
            fmt.METADATA_TYPE_STREAMINFO, len(si), is_last))
        self.out.write(si)
        if self._seektable is not None:
            # reserve the full table now; patched at finish like the
            # reference's update_metadata_ (stream_encoder.c:3139-3300)
            body = self._seektable.to_bytes()
            last = padding <= 0 and not extra
            self.out.write(metadata_block_header(
                fmt.METADATA_TYPE_SEEKTABLE, len(body), last))
            self._seektable_pos = self.out.tell()
            self.out.write(body)
        for i, blk in enumerate(extra):
            last = (padding <= 0) and i == len(extra) - 1
            self.out.write(metadata_block_header(blk[0], len(blk[1]), last))
            self.out.write(blk[1])
        if padding > 0:
            self.out.write(metadata_block_header(
                fmt.METADATA_TYPE_PADDING, padding, True))
            self.out.write(b"\x00" * padding)
        self._first_frame_offset = self.out.tell()

    def process(self, pcm: np.ndarray):
        """pcm: [C, n] int32 samples, one row per channel."""
        self._check_open()
        assert pcm.shape[0] == self.cfg.channels
        # a copy: the MD5 worker reads it after process() has returned,
        # when the caller may be refilling its own array
        pcm = np.array(pcm, dtype=np.int32, order="C")
        self._md5_queue.put(pcm)
        self._info.total_samples += pcm.shape[1]
        self._buf = np.concatenate([self._buf, pcm], axis=1)
        try:
            self._drain(final=False)
        except BaseException:
            self.close()
            raise

    def _drain(self, final: bool):
        N = self.blocksize
        B = self.batch_frames
        C = self.cfg.channels
        while True:
            if final:
                avail = self._buf.shape[1] // N
            else:
                # keep >= 1 sample beyond the last full block so the final
                # (possibly short) block is only emitted at finish
                # (OVERREAD_ buffering, stream_encoder.c:2554-2565)
                avail = max(0, (self._buf.shape[1] - 1) // N)
            if avail == 0:
                break
            # full batches ride the super-chunk path, the rest the trimmed
            # fetch
            nb = (min(avail // B, self._super_batches) * B if avail >= B
                  else avail)
            chunk = self._buf[:, :nb * N]
            self._buf = self._buf[:, nb * N:]
            blocks = chunk.reshape(C, nb, N).transpose(1, 0, 2)
            if avail >= B:
                self._emit_super(blocks, N)
            else:
                self._emit(blocks, N)
        if final and self._buf.shape[1] > 0:
            self._emit(self._buf.reshape(C, 1, -1).transpose(1, 0, 2),
                       self._buf.shape[1])
            self._buf = self._buf[:, :0]

    def _upload(self, blocks: np.ndarray) -> torch.Tensor:
        """[B, C, N] host blocks -> the device; sources of 16 bits or fewer
        cross as int16, which the encode program widens (the reference's
        encode_widen)."""
        narrow = self.cfg.bits_per_sample <= 16
        host = torch.from_numpy(np.ascontiguousarray(
            blocks, np.int16 if narrow else np.int32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _encode(self, blocks: np.ndarray, first, N: int, layout: str):
        pcm = torch.from_numpy(np.ascontiguousarray(blocks, np.int32)).to(
            self.device)
        if not isinstance(first, int):
            first = torch.from_numpy(first).to(self.device)
        return encode_batch(pcm, first, self.cfg, N, layout=layout,
                            packer=self.packer)

    def _emit_super(self, blocks: np.ndarray, N: int):
        """blocks: [G*B, C, N] int32, G >= 1 full batches: one encode each,
        whose word rows stay on the device (see _SuperJob)."""
        B = self.batch_frames
        words_list, lens_list = [], []
        for g in range(blocks.shape[0] // B):
            pf = encode_batch(self._upload(blocks[g * B:(g + 1) * B]),
                              self._frame_number + g * B, self.cfg, N,
                              packer=self.packer)
            words_list.append(pf.words)
            lens_list.append(_flag_lens(pf.byte_len, pf.ok))
            self._poll()
        self._inflight.append(_SuperJob(words_list, torch.cat(lens_list),
                                        blocks, N, self._frame_number))
        self._frame_number += blocks.shape[0]
        self._poll()
        while len(self._inflight) > self._super_depth:
            self._drain_one_inflight()

    def _emit(self, blocks: np.ndarray, N: int):
        """blocks: [B, C, N] int32: one batch through the trimmed fetch,
        the pipeline kept at most `pipeline_depth` deep."""
        fw = default_fetch_words(N, blocks.shape[1],
                                 self.cfg.bits_per_sample)
        main, rest = encode_batch_trimmed(
            self._upload(blocks), self._frame_number, self.cfg, N, fw,
            packer=self.packer)
        self._inflight.append(_BatchJob(main, rest, blocks, N,
                                        self._frame_number))
        self._frame_number += blocks.shape[0]
        self._poll()
        while len(self._inflight) > self._pipeline_depth:
            self._drain_one_inflight()

    def _poll(self):
        for job in self._inflight:
            job.poll()

    def _drain_one_inflight(self):
        self._poll()
        job = self._inflight.pop(0)
        if isinstance(job, _SuperJob):
            buf, lens = job.wait()
            bad = job.bad
            wbytes = _big_endian_rows(buf)
            if int(lens.max()) > wbytes.shape[1]:
                # a frame longer than the copied rows would be cut short
                # by _write_frames' row slicing: fail loudly instead
                raise RuntimeError(
                    f"frame exceeded super-chunk fetch buffer: "
                    f"{int(lens.max())} > {wbytes.shape[1]} (encoder bug)")
            self._poll()
        else:
            buf = job.main.wait()
            lens = buf[:, 0].astype(np.int64)
            bad = lens >= (1 << 30)
            lens = np.where(bad, 0, lens & ((1 << 30) - 1))
            wbytes = _big_endian_rows(buf[:, 1:])
            if int(lens.max()) > wbytes.shape[1]:
                # rare: a frame compressed past the trim point; splice the
                # remainder words in (one more copy, for this batch only)
                self.remainder_fetches += 1
                wbytes = np.concatenate(
                    [wbytes, _words_to_wbytes(job.rest, job.rest.shape[1])],
                    axis=1)
                if int(lens.max()) > wbytes.shape[1]:
                    # the pow2 word rows bound a verbatim frame: fail
                    # loudly rather than write a truncated stream
                    raise RuntimeError(
                        f"frame exceeded worst-case pack buffer: "
                        f"{int(lens.max())} > {wbytes.shape[1]} "
                        "(encoder bug)")
        self._write_frames(wbytes, lens, job.blocks, job.mb, job.N,
                           job.base, bad)

    def _replace_bad_frames(self, wbytes, lens, blocks, bad, N, base_frame):
        """Re-encode quad-layout misfit frames through the exact safe
        layout (one field per sample) and splice them in.  Sparse misfits
        go in power-of-two buckets of the misfit frames alone, with their
        own frame numbers; dense misfits (more than max(8, B/8)) take one
        full-batch safe pass."""
        lens = np.array(lens, np.int64, copy=True)
        bad_idx = [int(i) for i in np.nonzero(bad)[0]]
        B = len(blocks)
        self.misfit_frames += len(bad_idx)
        if len(bad_idx) > max(8, B // 8):
            pf = self._encode(blocks, base_frame, N, "safe")
            lens2 = pf.byte_len.cpu().numpy().astype(np.int64)
            return (_words_to_wbytes(pf.words, (int(lens2.max()) + 3) // 4),
                    lens2)
        rows = {}
        maxlen = int(lens.max())
        pos = 0
        while pos < len(bad_idx):
            take = bad_idx[pos:pos + 128]
            pos += len(take)
            nb = max(1, 1 << (len(take) - 1).bit_length())
            sel = np.stack([blocks[i] for i in take]
                           + [blocks[take[-1]]] * (nb - len(take)))
            # per-frame numbers: pass (number_i - i) so encode_batch's
            # +arange(B) lands each frame on its real number
            nums = np.asarray(
                [base_frame + i for i in take]
                + [base_frame + take[-1]] * (nb - len(take)), np.int64)
            nums = nums - np.arange(nb, dtype=np.int64)
            pf = self._encode(sel, nums, N, "safe")
            lns = pf.byte_len.cpu().numpy().astype(np.int64)
            rb = _words_to_wbytes(pf.words, (int(lns.max()) + 3) // 4)
            for j, i in enumerate(take):
                rows[i] = (rb[j], int(lns[j]))
                maxlen = max(maxlen, int(lns[j]))
        if maxlen > wbytes.shape[1]:
            wbytes = np.pad(wbytes, ((0, 0), (0, maxlen - wbytes.shape[1])))
        elif not wbytes.flags.writeable:
            wbytes = wbytes.copy()
        for i, (rb, ln) in rows.items():
            wbytes[i, :ln] = rb[:ln]
            lens[i] = ln
        return wbytes, lens

    def _write_frames(self, wbytes, lens, blocks, B, N, base_frame, bad):
        if bad.any():
            wbytes, lens = self._replace_bad_frames(
                wbytes, lens, blocks, bad, N, base_frame)
        blob = native.gather_frames(wbytes, lens)
        if self.verify:
            self._verify_batch(blocks, blob, lens, N, base_frame)
        if self._seektable is not None:
            base = self.out.tell() - self._first_frame_offset
            offs = base + np.concatenate([[0], np.cumsum(lens[:-1])])
            for i in range(B):
                self._frame_index.append(
                    ((base_frame + i) * self.blocksize, int(offs[i]), N))
        if hasattr(self.out, "write_frames"):
            # container sinks (Ogg) that packetize per frame take the
            # batch with its length table instead of raw bytes
            self.out.write_frames(blob, lens, N)
        else:
            self.out.write(blob)
        self._bytes_written += len(blob)
        self._info.min_framesize = min(self._info.min_framesize,
                                       int(lens.min()))
        self._info.max_framesize = max(self._info.max_framesize,
                                       int(lens.max()))
        if self._progress is not None:
            self._progress(base_frame + B, self.blocksize,
                           self._bytes_written)

    def _verify_batch(self, blocks: np.ndarray, blob: bytes,
                      lens: np.ndarray, N: int, base_frame: int):
        """Encoder verify loopback (`-V`, stream_encoder.c:1287-1325,
        2334-2352): decode every emitted frame on the device and compare it
        sample for sample with the input before any byte reaches the
        output."""
        B = lens.shape[0]
        st = DecodedStream()
        st.sample_rate = self.cfg.sample_rate
        st.channels = self.cfg.channels
        st.bits_per_sample = self.cfg.bits_per_sample
        # frame boundaries are exactly the emitted lengths: parse each
        # header in place rather than re-scanning for sync
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        frames = []
        for i in range(B):
            h = parse_frame_header(blob, int(offs[i]), st)
            if h is None:
                raise RuntimeError(
                    f"verify: emitted frame {base_frame + i} has "
                    "an invalid header (encoder bug)")
            h["size"] = int(lens[i])
            frames.append(h)
        try:
            decoded = decode_frame_list(blob, st, frames, device=self.device)
        except FlacDecodeError as e:
            raise RuntimeError(
                f"verify: emitted frames fail to decode ({e}; stream NOT "
                "written)") from e
        for i, sig in enumerate(decoded):
            if not np.array_equal(sig, blocks[i]):
                bad = np.nonzero(sig != blocks[i])
                raise RuntimeError(
                    "verify mismatch in audio data: frame "
                    f"{base_frame + i}, channel {int(bad[0][0])}, "
                    f"sample {int(bad[1][0])} (stream NOT written)")

    def _resolve_seektable(self):
        """Fill template points with real frame positions (the encoder-side
        seekpoint resolution of write_frame_/update_metadata_)."""
        resolved, seen = [], set()
        fidx = self._frame_index
        starts = [f[0] for f in fidx]
        for p in self._seektable.points:
            if p.sample_number == fmt.SEEKPOINT_PLACEHOLDER or not fidx:
                continue
            i = bisect.bisect_right(starts, min(p.sample_number,
                                                self._info.total_samples - 1))
            i = max(0, i - 1)
            fs, off, bs = fidx[i]
            if fs not in seen:
                seen.add(fs)
                resolved.append(SeekPoint(fs, off, bs))
        resolved.sort(key=lambda p: p.sample_number)
        pad = len(self._seektable.points) - len(resolved)
        resolved += [SeekPoint(fmt.SEEKPOINT_PLACEHOLDER, 0, 0)] * pad
        self._seektable.points = resolved

    def _check_open(self):
        if self._closed:
            raise RuntimeError("StreamEncoder is closed")

    def close(self):
        """Mark the encoder closed (later process() and finish() calls
        raise), drop the work in flight and stop the MD5 worker.  Safe to
        call repeatedly; an error in process() or finish() calls it."""
        self._closed = True
        self._inflight = []
        self._stop_md5()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def finish(self):
        self._check_open()
        try:
            self._drain(final=True)
            while self._inflight:
                self._drain_one_inflight()
        except BaseException:
            self.close()
            raise
        self._stop_md5()
        if self._md5_errors:
            raise self._md5_errors[0]
        self._info.md5 = self._md5.digest()
        if self.out.seekable():
            pos = self.out.tell()
            self.out.seek(self._header_pos + 4)
            self.out.write(self._info.to_bytes())
            if self._seektable is not None:
                self._resolve_seektable()
                self.out.seek(self._seektable_pos)
                self.out.write(self._seektable.to_bytes())
            self.out.seek(pos)
        return self._info


def encode_file_to_flac(pcm: np.ndarray, cfg: EncoderConfig,
                        out=None, **kw) -> bytes:
    """Convenience one-shot: pcm [C, n] int32 -> FLAC byte stream.
    Keyword arguments go to StreamEncoder (device, packer, batch_frames,
    padding, extra_metadata, seektable, verify, pipeline_depth,
    super_batches, progress_callback)."""
    buf = out or io.BytesIO()
    with StreamEncoder(buf, cfg, **kw) as enc:
        enc.process(pcm)
        enc.finish()
    return buf.getvalue() if out is None else None
