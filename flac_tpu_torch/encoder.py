"""Stream encoder: the batched device pipeline + host-side stream assembly.

Port of flac_tpu/encoder.py.

  [B, C, N] int32 PCM blocks on the device
      -> stereo candidates + wasted bits        (models/stereo.py)
      -> exact candidate grid search + realize  (models/subframe.py)
      -> channel assignment argmin              (models/stereo.py)
      -> field assembly, bit-pack, CRCs         (models/frame.py, K1)
      -> [B, W] packed words + lengths

The host loop is plain: each batch is encoded on the device, its words
come back with `.cpu()`, and its frames are written in order.  MD5 runs on
the host (hashlib), and the STREAMINFO block is back-patched at finish
exactly like update_metadata_ (stream_encoder.c:3139-3300), with the seek
table resolved to real frame positions.  With verify=True each batch is
decoded back on the device (the "device" engine: K2, then K3) and compared
with its input before a byte of it is written.

encode_batch marks its stages as profiler ranges (flac.search,
flac.assign, flac.assemble, and flac.pack inside assemble_frames): a few
microseconds of host time each while torch.profiler is not recording.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import io
import struct

import numpy as np
import torch
from torch.profiler import record_function

from . import format as fmt
from .config import EncoderConfig
from .decoder import decode_frame_list, parse_frame_header
from .device import resolve_device
from .metadata import SeekPoint
from .models import frame as frame_mod
from .models import stereo as stereo_mod
from .models import subframe as subframe_mod
from .ops import lpc as lpc_ops
from .ref_decoder import DecodedStream, FlacDecodeError
from .utils.bits import BitWriter


@functools.lru_cache(maxsize=None)
def _bank_for(cfg: EncoderConfig, blocksize: int):
    return lpc_ops.build_apodization_bank(blocksize, cfg.apodizations)


def encode_batch(pcm, first_frame_number, cfg: EncoderConfig,
                 blocksize: int, layout: str = "auto",
                 packer: str = "kernel") -> frame_mod.PackedFrames:
    """Encode a batch of equal-size blocks into packed FLAC frames.

    pcm: [B, C, N] int32 tensor (N == blocksize) on the encoding device
    first_frame_number: int, or [B] int64 tensor — frame index of pcm[0]
        (the frames are numbered first_frame_number + arange(B))
    cfg: a resolved EncoderConfig
    layout: frame.assemble_frames pack layout ("auto" = fused-quad when
        eligible; frames it can't represent come back ok=False and are
        re-encoded with layout="safe" — see StreamEncoder._write_frames).
    packer: the quad-layout deposit, see frame.assemble_frames.
    """
    B = pcm.shape[0]
    dev = pcm.device
    bank = _bank_for(cfg, blocksize)
    with record_function("flac.search"):
        x, bps_eff, wasted = stereo_mod.build_channel_candidates(pcm, cfg)
        choice = subframe_mod.search_and_realize(x, bps_eff, wasted, cfg,
                                                 bank)
    with record_function("flac.assign"):
        if pcm.shape[1] == 2 and cfg.do_mid_side:
            if cfg.loose_mid_side:
                assignment, ch_index = stereo_mod.loose_assignment(pcm, cfg)
            else:
                assignment, ch_index = stereo_mod.select_assignment(
                    choice.bits, cfg)
            choice = stereo_mod.gather_channels(choice, ch_index)
            signal = stereo_mod.gather_channels(x, ch_index)
        else:
            assignment = torch.zeros((B,), dtype=torch.int32, device=dev)
            signal = x
        if cfg.limit_min_bitrate:
            # force the last subframe of an all-constant frame to verbatim
            # so frames never shrink to a few bytes
            # (stream_encoder.c:3874-3879)
            all_const = (choice.type_ == fmt.SUBFRAME_TYPE_CONSTANT).all(
                dim=1)
            new_type = choice.type_.clone()
            new_type[:, -1] = torch.where(
                all_const, fmt.SUBFRAME_TYPE_VERBATIM, choice.type_[:, -1])
            choice = choice._replace(type_=new_type)
    frame_numbers = torch.as_tensor(first_frame_number, dtype=torch.int64,
                                    device=dev) + torch.arange(
        B, dtype=torch.int64, device=dev)
    with record_function("flac.assemble"):
        return frame_mod.assemble_frames(choice, signal, assignment,
                                         frame_numbers, cfg, blocksize,
                                         layout=layout, packer=packer)


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


def _words_to_wbytes(words: torch.Tensor, ncols: int) -> np.ndarray:
    """[B, W] int64 device words -> [B, 4*ncols] big-endian host bytes."""
    w32 = words[:, :ncols].to(torch.int32).cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(w32.astype(">u4")).view(np.uint8).reshape(
        w32.shape[0], -1)


class StreamEncoder:
    """Host-side streaming encoder: buffers PCM, encodes batches of
    `batch_frames` frames on the device, writes the byte stream in order,
    back-patches STREAMINFO (and the seek table) at finish.

    device: None means "cuda" (raises if no GPU is present); pass "cpu" to
    run on the CPU.  packer: the quad-layout deposit ("kernel" or
    "plain"), see models/frame.assemble_frames.
    extra_metadata: raw (type, body) blocks written after STREAMINFO and the
    seek table, before the padding.  seektable: a metadata.SeekTableBlock
    template (template_spaced, template_count, placeholders), resolved to
    real frame positions at finish.  verify: decode every batch on the
    device (decoder.decode_frame_list, the "device" engine) and compare it
    sample for sample with the input before a byte of it is written.
    progress_callback(frames_done, blocksize, bytes_written) runs after
    each written batch.  An `out` with a `write_frames` method (the Ogg
    sink, ogg.OggFlacSink) takes each batch with its frame lengths.
    """

    def __init__(self, out, cfg: EncoderConfig, *, batch_frames: int = 64,
                 padding: int = 4096, device=None, packer: str = "kernel",
                 extra_metadata: list | None = None, seektable=None,
                 verify: bool = False, progress_callback=None):
        self.out = out
        self.cfg = cfg.resolve()
        self.device = resolve_device(device)
        self.packer = packer
        self.batch_frames = batch_frames
        self.verify = verify
        self.blocksize = self.cfg.blocksize
        self._buf = np.zeros((self.cfg.channels, 0), np.int32)
        self._frame_number = 0
        self._md5 = hashlib.md5()
        self._info = StreamInfo(self.cfg)
        self._header_pos = None
        self._seektable = seektable       # SeekTableBlock template or None
        self._seektable_pos = None        # file offset of its body
        self._frame_index = []            # (first_sample, offset, blocksize)
        self._first_frame_offset = None
        self._progress = progress_callback
        self._bytes_written = 0
        self._closed = False
        self.misfit_frames = 0    # quad-layout misfits re-encoded "safe"
        self._write_stream_header(padding, extra_metadata or [])

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
        pcm = np.ascontiguousarray(pcm, np.int32)
        self._md5.update(interleave_for_md5(pcm, self.cfg.bits_per_sample))
        self._info.total_samples += pcm.shape[1]
        self._buf = np.concatenate([self._buf, pcm], axis=1)
        self._drain(final=False)

    def _drain(self, final: bool):
        N = self.blocksize
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
            nb = min(avail, self.batch_frames)
            chunk = self._buf[:, :nb * N]
            self._buf = self._buf[:, nb * N:]
            self._emit(chunk.reshape(self.cfg.channels, nb, N)
                       .transpose(1, 0, 2), N)
        if final and self._buf.shape[1] > 0:
            self._emit(self._buf.reshape(self.cfg.channels, 1, -1)
                       .transpose(1, 0, 2), self._buf.shape[1])
            self._buf = self._buf[:, :0]

    def _encode(self, blocks: np.ndarray, first, N: int, layout: str):
        pcm = torch.from_numpy(np.ascontiguousarray(blocks, np.int32)).to(
            self.device)
        if not isinstance(first, int):
            first = torch.from_numpy(first).to(self.device)
        return encode_batch(pcm, first, self.cfg, N, layout=layout,
                            packer=self.packer)

    def _emit(self, blocks: np.ndarray, N: int):
        """blocks: [B, C, N] int32 — encode one batch and write it."""
        B = blocks.shape[0]
        base = self._frame_number
        pf = self._encode(blocks, base, N, "auto")
        lens = pf.byte_len.cpu().numpy().astype(np.int64)
        bad = ~pf.ok.cpu().numpy()
        # a misfit frame's length is not its real one: size the copy by the
        # frames that are kept, and let the safe re-encode set the rest
        lens[bad] = 0
        wbytes = _words_to_wbytes(pf.words, (int(lens.max()) + 3) // 4)
        self._frame_number += B
        self._write_frames(wbytes, lens, blocks, B, N, base, bad)

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
        blob = b"".join(wbytes[i, :int(lens[i])].tobytes() for i in range(B))
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
        """Mark the encoder closed; later process() and finish() calls
        raise.  Safe to call repeatedly.  The port holds no worker thread
        or fetch pool, so there is nothing else to release."""
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def finish(self):
        self._check_open()
        self._drain(final=True)
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
    padding, extra_metadata, seektable, verify, progress_callback)."""
    buf = out or io.BytesIO()
    with StreamEncoder(buf, cfg, **kw) as enc:
        enc.process(pcm)
        enc.finish()
    return buf.getvalue() if out is None else None
