"""Device-engine decode: host tile skip-walk + Rice decode on the GPU.

Port of flac_tpu/decoder_device.py.  Per batch of same-shape frames:

  host:   the native skip-walk (native.tile_scan) finds where codes
          live, on a pool of 2 threads that runs 3 batches ahead (ctypes
          releases the GIL); range flac.tile_scan is the main thread's
          wait for a batch's walk, the part the pool does not hide;
  upload: the batch's slice of the COMPRESSED stream as big-endian words
          in 16-word rows, plus the lane and subframe tables (flac.upload);
  device: kernel K2 decodes the codes (flac.codes), kernel K3 runs the
          batched LPC restore and stereo undo (flac.restore);
  fetch:  `.cpu()` of the PCM and the flags (flac.fetch), then the commit:
          status handling, host re-decode of overflowing frames, MD5.

Frames whose tiles overflow the segment table (partition order > 8 on
large blocks) or whose unary runs overrun the window are decoded again on
the host, frame by frame, by the fused native decoder.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import native
from .decoder_fast import (_PIPELINE_DEPTH, StreamHasher, _group_arrays,
                          wide_frames)
from .ops import restore_cuda
from .ops.bitunpack import rice_decode_restore
from .ref_decoder import DecodedStream, FlacDecodeError

_NROW_BUCKETS = (2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64)
_SEG_BUCKETS = (2, 4, 6, 8)


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def _tile_T(N: int) -> int:
    """Tile size: 128 samples (= scan length) except for tiny blocks."""
    if N >= 128:
        return 128
    t = 16
    while t < N:
        t *= 2
    return t


def _prep_batch(arr, frames, idxs, blocksize, channels):
    """The native skip-walk for one batch (runs on the prep pool).  Besides
    the frames whose residuals overflow int32, `decoder_fast.wide_frames`
    marks frames wide, as in the fast engine's parse."""
    offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
        frames, idxs, channels)
    tg = native.tile_scan(arr, offsets, start_bits, sizes, ch_bps,
                          blocksize, T=_tile_T(blocksize))
    tg.wide |= wide_frames(ch_bps).astype(tg.wide.dtype)
    return tg, offsets, sizes, asg


def batch_inputs(arr, tg, offsets, sizes, asg):
    """The host arrays of one batch's decode, as `rice_decode_restore`
    takes them: (words2d, lane_start, segs, order, shift, qlp, wasted,
    assignment) and its static arguments (NROW, SEG, max_order, wide)."""
    # stream window: 64-byte-aligned slice covering the batch's frames,
    # as big-endian words in 16-word rows (+1 guard row for the
    # extractor's 2-word overread), their bits kept in int32
    base = int(offsets.min()) & ~63
    end = (int((offsets + sizes).max()) + 63) & ~63
    wb = arr[base:end]
    if len(wb) < end - base:
        wb = np.concatenate([wb, np.zeros(end - base - len(wb), np.uint8)])
    words2d = np.pad(
        np.ascontiguousarray(wb).view(">u4").astype(np.uint32)
        .reshape(-1, 16), ((0, 1), (0, 0))).view(np.int32)
    lane_start = (tg.lane_start - base * 8).astype(np.int32)

    # window rows: tile bits + 511 alignment slack + 160 extractor
    # overread (second unary stage at cur+64 reading 3 words); NROW sets
    # the window bound that decides lane_ovf
    NROW = _bucket(-(-(tg.max_tile_bits + 511 + 160) // 512),
                   _NROW_BUCKETS)
    SEG = _bucket(tg.max_segs + 1, _SEG_BUCKETS)
    mo = restore_cuda.kernel_order(int(tg.order.max(initial=0)))
    arrays = (words2d, lane_start, np.ascontiguousarray(tg.segs[:, :SEG]),
              tg.order, tg.shift, np.ascontiguousarray(tg.qlp[:, :mo]),
              tg.wasted, asg)
    return arrays, dict(NROW=NROW, SEG=SEG, max_order=mo,
                        wide=bool(tg.wide.any()))


def _dispatch(arr, blocksize, channels, bps, prep, device):
    """Upload one batch and launch its decode.  Returns ((pcm, oor,
    lane_ovf) on the device, tg, asg)."""
    tg, offsets, sizes, asg = prep
    arrays, kw = batch_inputs(arr, tg, offsets, sizes, asg)
    with record_function("flac.upload"):
        tensors = [torch.from_numpy(a).to(device) for a in arrays]
    out = rice_decode_restore(
        *tensors, T=_tile_T(blocksize), blocksize=blocksize,
        channels=channels, out16=(bps <= 16 and not kw["wide"]), bps=bps,
        **kw)
    return out, tg, asg


def decode_frame_list_device(data, st: DecodedStream, frames: list, *,
                             device, verify_crc: bool = True,
                             max_batch: int = 1024,
                             on_crc_error: str = "raise",
                             md5_hasher: StreamHasher | None = None) -> list:
    """Batched device-Rice decode of an explicit frame-header list on
    `device`; same contract as decoder.decode_frame_list."""
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

    def host_fallback(i):
        """Single-frame fused host decode (overflowing lanes or tables)."""
        f = frames[i]
        offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
            frames, [i], f["channels"])
        pcm, _eb, stt = native.decode_frames_full(
            arr, offsets, start_bits, sizes, ch_bps, f["blocksize"], asg,
            check_bps=st.bits_per_sample, verify_crc=verify_crc)
        return pcm[0], int(stt[0])

    def commit(out, tg, asg, idxs, blocksize, channels):
        F = len(idxs)
        tiles = tg.tiles
        with record_function("flac.fetch"):
            sig_np, oor_flags, lane_ovf = (v.cpu().numpy() for v in out)
        lane_bad = lane_ovf[:F * channels * tiles].reshape(
            F, channels * tiles).any(axis=1)
        bad: dict[int, str] = {}
        redo: list[int] = []
        for j in range(F):
            s = int(tg.status[j])
            if s == native.FT_SEG_OVERFLOW or \
                    (lane_bad[j] and s in (native.FT_OK,
                                           native.FT_EXTENT_MISMATCH)):
                redo.append(j)
                continue
            if s in (native.FT_OK, native.FT_EXTENT_MISMATCH):
                if oor_flags[j]:
                    if on_crc_error == "raise":
                        raise FlacDecodeError(
                            "decoded sample out of bps range (lost sync) "
                            f"at frame {frames[idxs[j]]['number']}")
                    bad[j] = "LOST_SYNC"
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
        if sig_np.dtype != np.int32:
            sig_np = sig_np.astype(np.int32)
        redo_pcm: dict[int, np.ndarray] = {}
        for j in redo:
            pcm, stt = host_fallback(idxs[j])
            if stt in (native.FT_OK, native.FT_EXTENT_MISMATCH) or \
                    (stt == native.FT_CRC16_BAD and not verify_crc):
                redo_pcm[j] = pcm
            else:
                label = ("FRAME_CRC_MISMATCH"
                         if stt == native.FT_CRC16_BAD else "LOST_SYNC")
                if on_crc_error == "raise":
                    raise FlacDecodeError(
                        f"frame decode failure ({label}) at frame "
                        f"{frames[idxs[j]]['number']}")
                bad[j] = label
        for j, i in enumerate(idxs):
            if j in bad:
                if not hasattr(st, "errors"):
                    st.errors = []
                st.errors.append((bad[j], frames[i]["number"]))
                continue
            results[i] = redo_pcm[j] if j in redo_pcm else sig_np[j]
        if md5_hasher is not None:
            if bad:
                md5_hasher.valid = False
            else:
                md5_hasher.add_packed(
                    [redo_pcm[j] if j in redo_pcm else sig_np[j]
                     for j in range(F)], idxs)

    prep_pool = ThreadPoolExecutor(max_workers=2)
    inflight = []
    try:
        prep_futs: dict[int, object] = {}

        def ensure_prepped(upto: int):
            for j in range(upto + 1):
                if j < len(batches) and j not in prep_futs:
                    bs_j, ch_j, idx_j = batches[j]
                    prep_futs[j] = prep_pool.submit(
                        _prep_batch, arr, frames, idx_j, bs_j, ch_j)

        for bi, (blocksize, channels, idxs) in enumerate(batches):
            ensure_prepped(bi + _PIPELINE_DEPTH)
            bps = st.bits_per_sample or max(frames[i]["bps"] for i in idxs)
            with record_function("flac.tile_scan"):
                prep = prep_futs.pop(bi).result()
            out, tg, asg = _dispatch(arr, blocksize, channels, bps, prep,
                                     device)
            inflight.append((out, tg, asg, idxs, blocksize, channels))
            while len(inflight) > _PIPELINE_DEPTH:
                commit(*inflight.pop(0))
        while inflight:
            commit(*inflight.pop(0))
    finally:
        prep_pool.shutdown(wait=True, cancel_futures=True)
    return results
