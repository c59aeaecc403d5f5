"""The "fast" decode engine (native full parse + kernel K3 on the device)
and the host-side pieces of the batched decoders: the frame tables, the
stream MD5, the all-CPU engine and the false-sync repair.

Port of flac_tpu/decoder_fast.py.  The fast engine splits each batch where
the hardware boundary is:

  host:   ft_parse_frames walks each frame's bits once on a pool of 2
          threads that runs _PIPELINE_DEPTH batches ahead (ctypes releases
          the GIL), extracting residuals and coefficients in the uniform
          LPC-restore form and checking the CRC-16 (range flac.parse is the
          main thread's wait for a batch's parse);
  upload: the residuals, as int16 where they fit, and the subframe tables
          (flac.upload);
  device: the restore, wasted-bit shift, stereo undo and range check of
          every subframe at once: kernel K3 (flac.restore);
  fetch:  `.cpu()` of the PCM and the flags (flac.fetch), then the commit.

Left out from the reference: the subframe-count padding (it exists to
reuse XLA compiles) and the fetch pool with `copy_to_host_async` (it exists
for the TPU's remote link).  `decode_frame_list_host` is the all-CPU
engine, the device engine's per-frame fallback, and an independent check of
both.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import format as fmt
from . import native
from .ops import restore_cuda
from .ref_decoder import DecodedStream, FlacDecodeError

_PIPELINE_DEPTH = 3     # batches the host stage runs ahead, and in flight


def restore_and_undo(res, order, shift, qlp, wasted, assignment, *,
                     blocksize: int, channels: int, max_order: int,
                     wide: bool = False, out16: bool = False, bps: int = 0):
    """Uniform batched subframe restore + stereo undo (K3, through
    `restore_cuda.restore_undo`: the plain version for CPU tensors).

    res:        [S, N] int16/int32 (int64 when wide) normalized residuals
    order/shift/wasted: [S] int32;  qlp: [S, max_order] int32
    assignment: [B] int32 (S = B * channels)
    Returns ([B, channels, N] PCM (int16 when out16, else int32/int64),
             [B] bool out-of-range flags: the stream_decoder.c:2458-2472
             bps-range lost-sync check, taken BEFORE any narrowing so that
             wrapped int16 values cannot evade it).  bps=0 disables the
             check.
    """
    with record_function("flac.restore"):
        return restore_cuda.restore_undo(
            res, order, shift, qlp, wasted, assignment, blocksize=blocksize,
            channels=channels, max_order=max_order, wide=wide, out16=out16,
            bps=bps)


def _group_arrays(frames, idxs, channels):
    """The input table of the native walks for one batch of frame indices:
    offsets, absolute start bits, sizes, stereo assignments and per-channel
    subframe bps (the side channel gets one bit more)."""
    F = len(idxs)
    offsets = np.empty(F, np.int64)
    start_bits = np.empty(F, np.int64)
    sizes = np.empty(F, np.int64)
    asg = np.empty(F, np.int32)
    ch_bps = np.empty((F, channels), np.int32)
    for j, i in enumerate(idxs):
        f = frames[i]
        offsets[j] = f["offset"]
        start_bits[j] = f["header_end_bits"]
        sizes[j] = f["size"]
        asg[j] = f["assignment"]
        for c in range(channels):
            extra = int(
                (f["assignment"] == fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE
                 and c == 1) or
                (f["assignment"] == fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE
                 and c == 0) or
                (f["assignment"] == fmt.CHANNEL_ASSIGNMENT_MID_SIDE
                 and c == 1))
            ch_bps[j, c] = f["bps"] + extra
    return offsets, start_bits, sizes, asg, ch_bps


WIDE_BPS = 32


def wide_frames(ch_bps: np.ndarray) -> np.ndarray:
    """[F] bool: the frames of a `_group_arrays` table whose restore and
    stereo undo run in int64, those with a subframe of WIDE_BPS bits or
    more, even where every residual fits int32 (a mid of 2^30 doubles past
    int32 in the undo).  Both device engines mark frames by it, and the
    native fused decode (flac_native.cpp, FT_WIDE_BPS) by the same bound."""
    return ch_bps.max(axis=1, initial=0) >= WIDE_BPS


def _parse_batch(arr, frames, idxs, blocksize, channels):
    """The native full parse of one batch (runs on the parse pool)."""
    offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
        frames, idxs, channels)
    wide = bool(wide_frames(ch_bps).any())
    pg = native.parse_frames(arr, offsets, start_bits, sizes, ch_bps,
                             blocksize, wide=wide)
    return pg, asg


def restore_inputs(pg, asg, blocksize: int, channels: int, bps: int):
    """The host arrays of one parsed batch as `restore_and_undo` takes them:
    (res, order, shift, qlp, wasted, assignment), res as int16 where every
    value fits (halving the upload), and its static arguments."""
    res = pg.res
    if not pg.wide and res.max(initial=0) < 32768 \
            and res.min(initial=0) >= -32768:
        res = res.astype(np.int16)
    mo = restore_cuda.kernel_order(int(pg.order.max(initial=0)))
    arrays = (res, pg.order, pg.shift, np.ascontiguousarray(pg.qlp[:, :mo]),
              pg.wasted, asg)
    return arrays, dict(blocksize=blocksize, channels=channels,
                        max_order=mo, wide=pg.wide,
                        out16=(bps <= 16 and not pg.wide), bps=bps)


def _dispatch_batch(pg, asg, blocksize, channels, bps, device):
    """Upload one parsed batch and launch its restore.  Returns (pcm, oor)
    on the device, in flight."""
    arrays, kw = restore_inputs(pg, asg, blocksize, channels, bps)
    with record_function("flac.upload"):
        tensors = [torch.from_numpy(a).to(device) for a in arrays]
    return restore_and_undo(*tensors, **kw)


def decode_frame_list_fast(data, st: DecodedStream, frames: list, *,
                           device, verify_crc: bool = True,
                           max_batch: int = 1024,
                           on_crc_error: str = "raise",
                           md5_hasher: StreamHasher | None = None) -> list:
    """Batched fast decode of an explicit frame-header list on `device`;
    same contract as decoder.decode_frame_list ([C, N] int32 per frame,
    None for frames dropped under on_crc_error="drop")."""
    results: list[np.ndarray | None] = [None] * len(frames)
    groups: dict[tuple, list[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    batches = []
    for (blocksize, channels), idxs in groups.items():
        for lo in range(0, len(idxs), max_batch):
            batches.append((blocksize, channels, idxs[lo:lo + max_batch]))

    def commit(out, pg, idxs):
        F = len(idxs)
        bad: dict[int, str] = {}
        for j in range(F):
            s = int(pg.status[j])
            if s in (native.FT_OK, native.FT_EXTENT_MISMATCH):
                continue
            if s == native.FT_CRC16_BAD and not verify_crc:
                continue
            label = ("FRAME_CRC_MISMATCH" if s == native.FT_CRC16_BAD
                     else "LOST_SYNC")
            if on_crc_error == "raise":
                kind = ("CRC16 mismatch" if s == native.FT_CRC16_BAD
                        else "parse failure (lost sync)")
                raise FlacDecodeError(
                    f"frame {kind} at frame {frames[idxs[j]]['number']}")
            bad[j] = label
        with record_function("flac.fetch"):
            sig_np, oor_flags = (v.cpu().numpy() for v in out)
        if sig_np.dtype != np.int32:
            sig_np = sig_np.astype(np.int32)
        # decoded-sample range check (stream_decoder.c:2458-2472), taken on
        # the device before the narrowing (see restore_and_undo)
        for j in np.nonzero(oor_flags)[0]:
            j = int(j)
            if j in bad:
                continue
            if on_crc_error == "raise":
                raise FlacDecodeError(
                    "decoded sample out of bps range (lost sync) at "
                    f"frame {frames[idxs[j]]['number']}")
            bad[j] = "LOST_SYNC"
        for j, i in enumerate(idxs):
            if j in bad:
                if not hasattr(st, "errors"):
                    st.errors = []
                st.errors.append((bad[j], frames[i]["number"]))
                continue
            results[i] = sig_np[j]
        if md5_hasher is not None:
            if bad:
                md5_hasher.valid = False
            else:
                md5_hasher.add_packed(sig_np, idxs)

    parse_pool = ThreadPoolExecutor(max_workers=2)
    inflight = []
    try:
        # the parse runs ahead of dispatch, but only a bounded window, so a
        # long file never holds more than ~_PIPELINE_DEPTH batches of
        # residuals in memory
        parse_futs: dict[int, object] = {}

        def ensure_parsed(upto: int):
            for j in range(upto + 1):
                if j < len(batches) and j not in parse_futs:
                    bs_j, ch_j, idx_j = batches[j]
                    parse_futs[j] = parse_pool.submit(
                        _parse_batch, arr, frames, idx_j, bs_j, ch_j)

        for bi, (blocksize, channels, idxs) in enumerate(batches):
            ensure_parsed(bi + _PIPELINE_DEPTH)
            bps = st.bits_per_sample or max(frames[i]["bps"] for i in idxs)
            with record_function("flac.parse"):
                pg, asg = parse_futs.pop(bi).result()
            out = _dispatch_batch(pg, asg, blocksize, channels, bps, device)
            inflight.append((out, pg, idxs))
            while len(inflight) > _PIPELINE_DEPTH:
                commit(*inflight.pop(0))
        while inflight:
            commit(*inflight.pop(0))
    finally:
        parse_pool.shutdown(wait=True, cancel_futures=True)
    return results


class StreamHasher:
    """Incremental stream-order MD5 (md5.c:497 FLAC__MD5Accumulate): hashes
    committed frames while later batches are still decoding.  Becomes
    invalid if any frame fails, is skipped, or arrives out of stream order;
    callers then hash the assembled samples instead."""

    def __init__(self, bps: int):
        self.h = native.MD5()
        self.bps = bps
        self.valid = True
        self.nframes = 0
        self._next = 0

    def _chain(self, idxs) -> bool:
        if not self.valid:
            return False
        if list(idxs) != list(range(self._next, self._next + len(idxs))):
            self.valid = False
            return False
        self._next += len(idxs)
        self.nframes += len(idxs)
        return True

    def add_span(self, view, idxs) -> None:
        """view: [C, n] int32 span of the final PCM array (any channel
        stride) covering frames idxs, hashed in place."""
        if self._chain(idxs):
            self.h.update_pcm(view, self.bps)

    def add_packed(self, pcm, idxs) -> None:
        """pcm: [F, C, N] int32 decoded batch for frame indices idxs."""
        if self._chain(idxs):
            for j in range(len(idxs)):
                self.h.update_pcm(pcm[j], self.bps)

    def digest(self) -> bytes:
        return self.h.digest()


def decode_frame_list_host(data, st: DecodedStream, frames: list, *,
                           verify_crc: bool = True,
                           on_crc_error: str = "raise",
                           md5_hasher: StreamHasher | None = None) -> list:
    """All-CPU decode: ONE fused native pass per frame (parse, in-place
    restore, stereo undo, range check: ft_decode_frames), chunks of the
    frame table on a thread pool (ctypes releases the GIL), decoding
    straight into the final channel-major PCM array (st._assembled exposes
    it to decode_stream_tpu)."""
    results: list[np.ndarray | None] = [None] * len(frames)
    groups: dict[tuple, list[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    nw = min(8, os.cpu_count() or 1)
    chunk = 64

    # uniform channel count => decode all groups straight into one final
    # [C, total] array at each frame's cumulative sample offset
    st._assembled = None
    offs = np.zeros(len(frames) + 1, np.int64)
    for i, f in enumerate(frames):
        offs[i + 1] = offs[i] + f["blocksize"]
    chans = {f["channels"] for f in frames}
    full = None
    if len(chans) == 1:
        full = np.empty((chans.pop(), int(offs[-1])), np.int32)

    def run_chunk(idxs, blocksize, channels):
        offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
            frames, idxs, channels)
        return native.decode_frames_full(
            arr, offsets, start_bits, sizes, ch_bps, blocksize, asg,
            check_bps=st.bits_per_sample, verify_crc=verify_crc,
            out=full, out_off=None if full is None else offs[list(idxs)])

    jobs = []
    with ThreadPoolExecutor(max_workers=nw) as pool:
        for (blocksize, channels), idxs in groups.items():
            for lo in range(0, len(idxs), chunk):
                sub = idxs[lo:lo + chunk]
                jobs.append((sub, blocksize,
                             pool.submit(run_chunk, sub, blocksize,
                                         channels)))
        all_ok = True
        for sub, blocksize, fut in jobs:
            pcm, _end_bits, status = fut.result()
            chunk_ok = True
            for j, i in enumerate(sub):
                s = int(status[j])
                ok = s in (native.FT_OK, native.FT_EXTENT_MISMATCH) or \
                    (s == native.FT_CRC16_BAD and not verify_crc)
                if not ok:
                    chunk_ok = all_ok = False
                    label = ("FRAME_CRC_MISMATCH"
                             if s == native.FT_CRC16_BAD else "LOST_SYNC")
                    if on_crc_error == "raise":
                        kind = ("CRC16 mismatch"
                                if s == native.FT_CRC16_BAD
                                else "parse failure (lost sync)")
                        raise FlacDecodeError(
                            f"frame {kind} at frame {frames[i]['number']}")
                    if not hasattr(st, "errors"):
                        st.errors = []
                    st.errors.append((label, frames[i]["number"]))
                    continue
                results[i] = (full[:, offs[i]:offs[i] + blocksize]
                              if full is not None else pcm[j])
            if md5_hasher is not None:
                if not chunk_ok:
                    md5_hasher.valid = False
                elif full is not None:
                    md5_hasher.add_span(
                        full[:, offs[sub[0]]:offs[sub[-1] + 1]], sub)
                else:
                    md5_hasher.add_packed(pcm, sub)
        if full is not None and all_ok:
            st._assembled = full
    return results


def repair_frame_table(data, st: DecodedStream, frames: list) -> list:
    """Strict-mode false-sync recovery (stream_decoder.c:2443-2480's
    decode-then-CRC16 rejection, batched): when a frame's payload happens
    to contain a byte pattern that scans as a valid next-numbered header,
    the scan truncates the real frame at the fake header and the frame
    fails to parse or CRC.  Re-parse such frames with an open-ended limit
    to find their true extent, drop the phantom entries the real frame
    swallowed, and rescan from the corrected end."""
    if not frames:
        return frames
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    from .decoder import scan_frames
    out = list(frames)
    changed = True
    rounds = 0
    max_rounds = 64
    while changed and rounds < max_rounds:
        changed = False
        rounds += 1
        groups: dict[tuple, list[int]] = {}
        for i, f in enumerate(out):
            groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
        bad_i = None
        for (blocksize, channels), idxs in groups.items():
            offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
                out, idxs, channels)
            pg = native.parse_frames(arr, offsets, start_bits, sizes,
                                     ch_bps, blocksize)
            for j, i in enumerate(idxs):
                if int(pg.status[j]) in (native.FT_PARSE_ERR,
                                         native.FT_CRC16_BAD):
                    bad_i = i if bad_i is None else min(bad_i, i)
        if bad_i is None:
            return out
        f = out[bad_i]
        # re-parse with the limit extended to the end of the stream
        open_sizes = np.asarray([len(arr) - f["offset"]], np.int64)
        offsets, start_bits, _, asg, ch_bps = _group_arrays(
            out, [bad_i], f["channels"])
        pg = native.parse_frames(arr, offsets, start_bits, open_sizes,
                                 ch_bps, f["blocksize"])
        if int(pg.status[0]) not in (native.FT_OK,
                                     native.FT_EXTENT_MISMATCH):
            return out      # genuinely corrupt: leave for error handling
        true_end = (int(pg.end_bits[0]) + 7) // 8 + 2
        f = dict(f)
        f["size"] = true_end - f["offset"]
        tail = scan_frames(data if isinstance(data, (bytes, bytearray))
                           else arr.tobytes(), st, true_end)
        # keep frames before the repaired one, then the rescanned tail
        # chained onto its numbering
        nxt = (f["number"] + 1 if not f["variable"]
               else f["number"] + f["blocksize"])
        tail = [t for t in tail if t["number"] >= nxt] if tail else []
        if tail and tail[0]["number"] != nxt:
            return out
        out = out[:bad_i] + [f] + tail
        for i2, g in enumerate(out):
            end = out[i2 + 1]["offset"] if i2 + 1 < len(out) else len(arr)
            if i2 != bad_i:
                g["size"] = end - g["offset"]
        changed = True
    if changed:
        # ran out of repair rounds with repairs still pending: say so
        # instead of returning a still-broken table silently
        import warnings
        warnings.warn(
            f"repair_frame_table gave up after {max_rounds} rounds with "
            "false-sync repairs still pending; the stream has pervasive "
            "in-payload sync patterns", RuntimeWarning, stacklevel=2)
    return out
