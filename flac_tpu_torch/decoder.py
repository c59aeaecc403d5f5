"""Batched FLAC decode: the host frame scan, then a decode engine.

Port of flac_tpu/decoder.py.  The host finds frame boundaries (byte-aligned
sync codes, CRC-8-verified headers and the sequential-number invariant, in
the native runtime; or, in tolerant mode, a resyncing scan that accepts
gaps) and hands the frame table to an engine:

  "device" (the default): the native tile skip-walk on the host, then the
      Rice code scan (kernel K2) and the restore and stereo undo (kernel
      K3) on the device (decoder_device.py);
  "fast":   the native full parse on the host, the residuals uploaded, then
      K3 on the device (decoder_fast.py);
  "host":   the fused all-CPU native decoder (decoder_fast.py);
  "scan":   the all-device per-sample bit reader, plain torch ops with no
      kernel: the reference's correctness oracle, not a fast path;
  "auto":   picks one of "host", "device" and "fast" by a wall-clock model
      (_pick_engine) built from H100 measurements.

tolerant=True decodes damaged streams as `flac -F` does: a leading ID3v2
tag is skipped, a stream without a fLaC marker or STREAMINFO is decoded
from its frame headers, bad frames are dropped and concealed with silence,
missing frames become silence, and an MD5 mismatch is recorded instead of
raised.  decode_stream_auto also takes Ogg FLAC (ogg.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import format as fmt
from . import native
from .decoder_device import decode_frame_list_device
from .decoder_fast import StreamHasher, _group_arrays, \
    decode_frame_list_fast, decode_frame_list_host, repair_frame_table
from .device import resolve_device
from .ops import bitpack
from .ops.bitunpack import _MASK32, _clz64
from .ops.crc import crc8 as _crc8
from .ref_decoder import (_BLOCKSIZE_TABLE, _BPS_TABLE, _SAMPLE_RATE_TABLE,
                          DecodedStream, FlacDecodeError, parse_metadata)
from .utils.bits import utf8_decode_int

ENGINES = ("device", "fast", "host", "scan", "auto")

_FIXED_TAPS = np.zeros((5, 4), np.int64)
_FIXED_TAPS[1, :1] = [1]
_FIXED_TAPS[2, :2] = [2, -1]
_FIXED_TAPS[3, :3] = [3, -3, 1]
_FIXED_TAPS[4, :4] = [4, -6, 4, -1]


# ---------------------------------------------------------------------------
# The "scan" engine: bit-reading primitives, batched over lanes
# ---------------------------------------------------------------------------
#
# buf is [B, M] int64 holding each frame's bytes (zero-padded); cursors are
# [B] int64 bit offsets.  A read past a row's end reads its last byte again
# (the reference's clipped gather).

def _bytes_at(buf, byte0, k: int):
    """[B] big-endian value of the k bytes from byte0 of each row."""
    M = buf.shape[-1]
    idx = (byte0[:, None] + torch.arange(k, device=buf.device)).clamp(0, M - 1)
    shifts = 8 * torch.arange(k - 1, -1, -1, device=buf.device)
    # the byte fields do not overlap, so the sum is their OR (it wraps mod
    # 2^64 like the reference's uint64 shifts)
    return (torch.gather(buf, 1, idx) << shifts).sum(1)


def _read_bits(buf, cursor, nbits):
    """Read `nbits` (<= 32, may be 0) MSB-first bits at bit offset `cursor`.
    Returns (value [B] as uint32 in int64, new cursor)."""
    val, cur = _read_bits_wide(buf, cursor, nbits)
    return val & _MASK32, cur


def _read_bits_wide(buf, cursor, nbits):
    """Like _read_bits but up to 33 bits (33-bit side-channel warmup,
    constant and verbatim fields, stream_decoder.c:3250-3293)."""
    win = _bytes_at(buf, cursor >> 3, 6)
    nb = nbits.to(torch.int64)
    sh = 48 - (cursor & 7) - nb
    val = (win >> sh) & ((torch.ones_like(nb) << nb) - 1)
    return val, cursor + nbits


def _read_unary(buf, cursor):
    """Count zero bits until the stop bit and consume through it.  Returns
    (q [B], new cursor): clz over 64-bit windows, looping while some lane's
    run crosses a window.

    A lane whose cursor has passed its row's end, where the row ends in a
    zero byte, would read zeros for ever (the reference's loop does not
    end there); such a lane stops.  Elsewhere the result is the
    reference's."""
    M = buf.shape[-1]
    stuck_row = buf[:, M - 1] == 0
    q = torch.zeros_like(cursor)
    cur = cursor
    done = torch.zeros(cursor.shape, dtype=torch.bool, device=cursor.device)
    while True:
        bitoff = cur & 7
        w = _bytes_at(buf, cur >> 3, 8) << bitoff   # current bit at the MSB
        usable = 64 - bitoff
        nz = _clz64((w >> 32) & _MASK32, w & _MASK32)
        hit = nz < usable
        step = torch.where(hit, nz, usable)
        q = torch.where(done, q, q + step)
        cur = torch.where(done, cur, cur + step + hit.to(torch.int64))
        done = done | hit | (stuck_row & ((cur >> 3) >= M))
        if bool(done.all()):
            return q, cur


def _read_signed(buf, cursor, nbits):
    """A signed nbits-wide field (nbits may be 0): (value, new cursor)."""
    v, cur = _read_bits_wide(buf, cursor, nbits)
    nb = nbits.to(torch.int64)
    sign = (v >> (nb - 1).clamp(min=0)) & (nb > 0).to(torch.int64)
    return v - (sign << nb), cur


def decode_frames_device(buf, start_bits, ch_bps, blocksize: int,
                         channels: int, max_bytes: int):
    """Decode the subframes of a batch of same-blocksize frames, one sample
    step at a time over every frame (flac_tpu/decoder.py:123-270).

    buf:        [B, max_bytes] uint8 (frame bytes, zero-padded)
    start_bits: [B] bit offset of the first subframe in its row
    ch_bps:     [B, C] per-channel subframe bps (the side channel +1)
    Returns (subframe signals [B, C, N] int64, wasted bits undone; end_bits
    [B], the cursor after the last subframe).
    """
    dev = buf.device
    B = buf.shape[0]
    N = blocksize
    buf = buf[:, :max_bytes].to(torch.int64)
    cursor = start_bits.to(torch.int64)
    i64 = dict(dtype=torch.int64, device=dev)
    taps = torch.as_tensor(_FIXED_TAPS, device=dev)
    outputs = []

    for c in range(channels):
        bps = ch_bps[:, c].to(torch.int64)
        hdr, cursor = _read_bits(buf, cursor, torch.full((B,), 8, **i64))
        type6 = (hdr >> 1) & 0x3F
        wflag = hdr & 1
        q, cur2 = _read_unary(buf, cursor)
        cursor = torch.where(wflag == 1, cur2, cursor)
        wasted = torch.where(wflag == 1, q + 1, 0)
        ebps = bps - wasted

        is_const = type6 == 0
        is_verb = type6 == 1
        is_fixed = (type6 & 0x38) == 0x08
        is_lpc = (type6 & 0x20) != 0
        order = torch.where(is_fixed, type6 & 0x07,
                            torch.where(is_lpc, (type6 & 0x1F) + 1, 0))
        has_res = is_fixed | is_lpc

        const_val, cursor = _read_signed(buf, cursor,
                                         torch.where(is_const, ebps, 0))
        warm = []
        for j in range(fmt.MAX_LPC_ORDER):
            v, cursor = _read_signed(
                buf, cursor, torch.where(has_res & (j < order), ebps, 0))
            warm.append(v)
        v, cursor = _read_bits(buf, cursor, torch.where(is_lpc, 4, 0))
        prec = v + 1
        shift, cursor = _read_signed(buf, cursor, torch.where(is_lpc, 5, 0))
        qlp = []
        for j in range(fmt.MAX_LPC_ORDER):
            v, cursor = _read_signed(
                buf, cursor, torch.where(is_lpc & (j < order), prec, 0))
            qlp.append(v)
        qlp = torch.stack(qlp, dim=1)                      # [B, 32]

        # residual method + partition order
        v, cursor = _read_bits(buf, cursor, torch.where(has_res, 6, 0))
        method = v >> 4
        po = v & 0xF
        plen = torch.where(method == 1, 5, 4)
        esc = (torch.ones_like(plen) << plen) - 1
        m = N >> po                                        # [B]
        fixed = torch.nn.functional.pad(taps[order.clamp(0, 4)], (0, 28))
        pred_coeffs = torch.where(is_lpc[:, None], qlp, fixed)
        pred_shift = torch.where(is_lpc, shift, 0)

        hist = torch.zeros((B, fmt.MAX_LPC_ORDER), **i64)
        cur = cursor
        k = torch.zeros((B,), **i64)
        rawbits = torch.full((B,), -1, **i64)
        xs = []
        for n in range(N):
            # partition boundary: read the next parameter.  x % 0 is x in
            # the reference's integer semantics, so m == 0 never starts one
            at_start = (order == n) | ((n > 0) & (m > 0)
                                       & (n % m.clamp(min=1) == 0))
            do_param = has_res & at_start
            pv, cur_p = _read_bits(buf, cur, torch.where(do_param, plen, 0))
            is_esc = do_param & (pv == esc)
            rw, cur_p = _read_bits(buf, cur_p, torch.where(is_esc, 5, 0))
            k = torch.where(do_param, pv, k)
            rawbits = torch.where(do_param, torch.where(is_esc, rw, -1),
                                  rawbits)
            cur = cur_p
            in_res = has_res & (n >= order)
            escaped = in_res & (rawbits >= 0)
            riced = in_res & (rawbits < 0)

            # Rice code: unary q, then k LSBs
            uq, cur_u = _read_unary(buf, cur)
            cur = torch.where(riced, cur_u, cur)
            lsb, cur = _read_bits(buf, cur, torch.where(riced, k, 0))
            u = (uq << k) | lsb
            rice_res = (u >> 1) ^ -(u & 1)

            # escaped partition: raw signed rawbits
            rv, cur = _read_bits(buf, cur, torch.where(escaped, rawbits, 0))
            raw_res = rv - (((rv >> (rawbits - 1).clamp(min=0)) & 1)
                            << rawbits)
            res = torch.where(escaped, raw_res, rice_res)

            # verbatim sample
            vv = torch.where(is_verb, ebps, 0)
            vraw, _ = _read_signed(buf, cur, vv)
            cur = cur + vv

            pred = (pred_coeffs * hist).sum(1) >> pred_shift
            xn = torch.where(is_const, const_val,
                             torch.where(is_verb, vraw,
                                         torch.where(in_res, res + pred,
                                                     warm[min(n, 31)])))
            hist = torch.cat([xn[:, None], hist[:, :-1]], dim=1)
            xs.append(xn)
        cursor = cur
        sig = torch.stack(xs, dim=1) if xs else torch.zeros((B, 0), **i64)
        outputs.append(sig << wasted[:, None])

    return torch.stack(outputs, dim=1), cursor


def _undo_stereo(sig, assignment):
    """sig [B, 2, N] int64, assignment [B] -> [B, 2, N]
    (stream_decoder.c:3476-3526)."""
    a, b = sig[:, 0], sig[:, 1]
    asg = assignment[:, None]
    mid = (a << 1) | (b & 1)
    left = torch.where(asg == fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE, b + a,
                       torch.where(asg == fmt.CHANNEL_ASSIGNMENT_MID_SIDE,
                                   (mid + b) >> 1, a))
    right = torch.where(asg == fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE, a - b,
                        torch.where(asg == fmt.CHANNEL_ASSIGNMENT_MID_SIDE,
                                    (mid - b) >> 1, b))
    return torch.stack([left, right], dim=1)


def decode_frame_list_scan(data, st: DecodedStream, frames: list, *,
                           device, verify_crc: bool = True,
                           max_batch: int = 1024,
                           on_crc_error: str = "raise") -> list:
    """The "scan" engine (flac_tpu/decoder.py:589-678): every frame's bytes
    uploaded, decode_frames_device, the stereo undo, a CRC-16 check of each
    frame's real extent on the device (ops/bitpack.crc16_words) and the
    bps-range check; same contract as decode_frame_list."""
    results: list[np.ndarray | None] = [None] * len(frames)
    groups: dict[tuple, list[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    for (blocksize, channels), idxs in groups.items():
        for lo in range(0, len(idxs), max_batch):
            batch = idxs[lo:lo + max_batch]
            maxlen = max(frames[i]["size"] for i in batch)
            # a power-of-two word count (crc16_words' tree fold)
            maxlen = 4 << max(0, int(np.ceil(np.log2(max(maxlen, 4) / 4))))
            B = len(batch)
            offsets, start_bits, _, asg, ch_bps = _group_arrays(
                frames, batch, channels)
            buf = np.zeros((B, maxlen), np.uint8)
            for j, i in enumerate(batch):
                f = frames[i]
                buf[j, :f["size"]] = arr[f["offset"]:f["offset"] + f["size"]]
            starts = start_bits - offsets * 8
            sig, end_bits = decode_frames_device(
                torch.from_numpy(buf).to(device),
                torch.from_numpy(starts).to(device),
                torch.from_numpy(ch_bps).to(device), blocksize, channels,
                maxlen)
            if channels == 2:
                sig = _undo_stereo(sig, torch.from_numpy(asg).to(device))
            if verify_crc:
                # the frame's real extent comes from the decode cursor (last
                # subframe end, byte-aligned, then 2 CRC bytes), not the
                # scan span: a lost next header inflates the span and must
                # not move where this frame's CRC-16 is read
                sizes = (end_bits.cpu().numpy() + 7) // 8 + 2
                scan_sizes = np.array([frames[i]["size"] for i in batch],
                                      np.int64)
                sizes = np.minimum(sizes, scan_sizes)    # truncation guard
                stored = np.array(
                    [int.from_bytes(bytes(buf[j, sizes[j] - 2:sizes[j]]),
                                    "big") for j in range(B)], np.int64)
                bufm = buf.copy()
                for j in range(B):
                    bufm[j, sizes[j] - 2:] = 0
                words = torch.from_numpy(np.ascontiguousarray(bufm).view(
                    ">u4").astype(np.int64)).to(device)
                got = bitpack.crc16_words(
                    words, torch.from_numpy(sizes - 2).to(device))
                bad = set(np.nonzero(got.cpu().numpy() != stored)[0].tolist())
                if bad and on_crc_error == "raise":
                    raise FlacDecodeError(
                        "frame CRC16 mismatch at frame "
                        f"{frames[batch[min(bad)]]['number']}")
            else:
                bad = set()
            sig_np = sig.cpu().numpy()
            # decoded-sample range check (stream_decoder.c:2458-2472): a
            # sample outside the stream's bps range means lost sync
            lim = 1 << (st.bits_per_sample - 1)
            oor = np.nonzero(np.any((sig_np < -lim) | (sig_np >= lim),
                                    axis=(1, 2)))[0]
            labels = {j: "FRAME_CRC_MISMATCH" for j in bad}
            for j in oor:
                j = int(j)
                if j in bad:
                    continue
                if on_crc_error == "raise":
                    raise FlacDecodeError(
                        "decoded sample out of bps range (lost sync) at "
                        f"frame {frames[batch[j]]['number']}")
                bad.add(j)
                labels[j] = "LOST_SYNC"
            for j, i in enumerate(batch):
                if j in bad:
                    if not hasattr(st, "errors"):
                        st.errors = []
                    st.errors.append((labels[j], frames[i]["number"]))
                    continue
                results[i] = sig_np[j].astype(np.int32)
    return results


# ---------------------------------------------------------------------------
# Host: frame table scans
# ---------------------------------------------------------------------------

def parse_frame_header(data: bytes, pos: int, st: DecodedStream):
    """Parse one byte-aligned frame header; returns a dict or None."""
    try:
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            return None
        variable = data[pos + 1] & 1
        bs_code, sr_code = data[pos + 2] >> 4, data[pos + 2] & 0xF
        b3 = data[pos + 3]
        ch_code, bps_code = b3 >> 4, (b3 >> 1) & 0x7
        if bs_code == 0 or sr_code == 15 or ch_code > 10 or (b3 & 1):
            return None
        if bps_code == 3 or (bps_code == 0 and st.bits_per_sample == 0):
            return None
        number, nb = utf8_decode_int(data, pos + 4)
        p = pos + 4 + nb
        if bs_code == 6:
            blocksize = data[p] + 1
            p += 1
        elif bs_code == 7:
            blocksize = int.from_bytes(data[p:p + 2], "big") + 1
            p += 2
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            sample_rate = data[p] * 1000
            p += 1
        elif sr_code == 13:
            sample_rate = int.from_bytes(data[p:p + 2], "big")
            p += 2
        elif sr_code == 14:
            sample_rate = int.from_bytes(data[p:p + 2], "big") * 10
            p += 2
        elif sr_code == 0:
            sample_rate = st.sample_rate
        else:
            sample_rate = _SAMPLE_RATE_TABLE[sr_code]
        if _crc8(data[pos:p]) != data[p]:
            return None
        channels = ch_code + 1 if ch_code < 8 else 2
        assignment = (fmt.CHANNEL_ASSIGNMENT_INDEPENDENT if ch_code < 8
                      else ch_code - 7)
        bps = st.bits_per_sample if bps_code == 0 else _BPS_TABLE[bps_code]
        return dict(offset=pos, number=number, blocksize=blocksize,
                    sample_rate=sample_rate, channels=channels,
                    assignment=assignment, bps=bps, variable=variable,
                    header_end_bits=(p + 1) * 8)
    except (IndexError, KeyError, ValueError):
        return None


def skip_id3v2(data: bytes) -> int:
    """Byte offset past a leading ID3v2 tag, 0 if none
    (skip_id3v2_tag_, stream_decoder.c:2299-2320): 10-byte header with a
    28-bit synchsafe size."""
    if data[:3] != b"ID3" or len(data) < 10:
        return 0
    size = 0
    for b in data[6:10]:
        size = (size << 7) | (b & 0x7F)
    return min(10 + size, len(data))


def _sync_candidates(data: bytes, start: int) -> np.ndarray:
    arr = np.frombuffer(data, np.uint8)
    cand = np.where((arr[:-1] == 0xFF) & ((arr[1:] & 0xFC) == 0xF8))[0]
    return cand[cand >= start]


def _fill_sizes(frames: list, end: int) -> list:
    for i, f in enumerate(frames):
        f["size"] = (frames[i + 1]["offset"] if i + 1 < len(frames)
                     else end) - f["offset"]
    return frames


def scan_frames_tolerant(data: bytes, st: DecodedStream, start: int):
    """Resyncing frame scan: accepts a mid-stream first frame and frame-
    number gaps (lost or corrupt frames), the scan-ahead equivalent of the
    reference's SEARCH_FOR_FRAME_SYNC recovery loop (stream_decoder.c:
    2321-2380, 2476-2480).

    A candidate that breaks the expected numbering chain is accepted only
    when a later CRC-8-valid header continues from it (or it covers the
    stream's tail): scan-ahead confirmation in place of the reference's
    decode-then-CRC16 rejection of false sync patterns.
    """
    cand = _sync_candidates(data, start)
    headers = {}

    def hdr_at(pos):
        if pos not in headers:
            headers[pos] = parse_frame_header(data, int(pos), st)
        return headers[pos]

    def next_number(h):
        return (h["number"] + 1 if not h["variable"]
                else h["number"] + h["blocksize"])

    def confirmed(pos, h):
        """A later candidate chains from h, or h plausibly reaches EOF."""
        i0 = int(np.searchsorted(cand, pos + 10))
        for q in cand[i0:i0 + 512]:
            if q > pos + (1 << 20):
                break
            h2 = hdr_at(q)
            if h2 is not None and h2["number"] == next_number(h):
                return True
        # tail frame: minimal sanity, it must fit a subframe and the CRC
        return len(data) - pos >= 10 and \
            len(data) - pos < h["blocksize"] * h["channels"] * 5 + 1024

    frames = []
    expected = None
    for pos in cand:
        if frames and pos < frames[-1]["offset"] + 10:
            continue
        h = hdr_at(pos)
        if h is None:
            continue
        if expected is None or h["number"] != expected:
            in_future = expected is None or h["number"] > expected
            if not (in_future and confirmed(pos, h)):
                continue
        frames.append(h)
        expected = next_number(h)
    return _fill_sizes(frames, len(data))


def stream_params_from_frames(data: bytes, start: int) -> DecodedStream:
    """Stream parameters from the first valid frame header, for streams with
    no STREAMINFO (stream_decoder.c:2712-2718).  Frames must carry explicit
    bps and sample-rate codes."""
    st = DecodedStream()
    for pos in _sync_candidates(data, start):
        h = parse_frame_header(data, int(pos), st)
        if h is not None:
            st.sample_rate = h["sample_rate"]
            st.channels = h["channels"]
            st.bits_per_sample = h["bps"]
            st.total_samples = 0
            st.md5 = b"\x00" * 16
            return st
    raise FlacDecodeError("no valid frame header found in stream")


def scan_frames(data: bytes, st: DecodedStream, start: int):
    """Locate all frames with the native sync scan; returns header dicts
    with 'size' filled in.  False sync patterns inside frame payloads are
    rejected by requiring consecutive frame/sample numbers (the
    fixed-blocksize stream invariant, format.h:403-406)."""
    frames = native.scan_frames(data, start, st.bits_per_sample,
                                st.sample_rate)
    return _fill_sizes(frames, len(data))


# ---------------------------------------------------------------------------
# Engine choice
# ---------------------------------------------------------------------------

_LINK_MBPS: dict = {}       # device -> measured MB/s, once per process

# The model's rates: chip_smoke.py phase 4 on an NVIDIA H100 80GB HBM3 at
# a 700 W power limit, on the machine's 8 CPU cores (PERF.md).  The host
# engine's MB/s of PCM per core it runs on (it uses at most 8: 186.7 MB/s
# on 8), and the device engines' MB/s on the 180 s -5 track, which their
# host work (tile walk or full parse, MD5, fetch) sets rather than the link
# (3,422 MB/s by the probe) or the card.
_HOST_DECODE_MBPS_PER_CORE = 23.3
_DEVICE_DECODE_MBPS = 95.9
_FAST_DECODE_MBPS = 81.1
_SMALL_STREAM_BYTES = 32 << 20


def probe_link_bandwidth(device=None) -> float:
    """Host<->device transfer rate in MB/s: one 4 MB round trip after a
    warm-up, measured once per device and process.  inf for the CPU (the
    host is the device).  FLAC_TPU_LINK_MBPS overrides it, for
    deterministic engine-policy tests."""
    env = os.environ.get("FLAC_TPU_LINK_MBPS")
    if env:
        return float(env)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return float("inf")
    key = str(dev)
    if key not in _LINK_MBPS:
        host = torch.zeros(4 << 20, dtype=torch.uint8)
        (host.to(dev) + 1).cpu()             # pays the first-touch costs
        t0 = time.perf_counter()
        (host.to(dev) + 2).cpu()
        dt = max(time.perf_counter() - t0, 1e-9)
        _LINK_MBPS[key] = (4 << 20) / dt / 1e6
    return _LINK_MBPS[key]


def _pick_engine(frames: list, device) -> str:
    """Route engine="auto" by a wall-clock model: the host engine runs at
    _HOST_DECODE_MBPS_PER_CORE times its cores (at most 8); the device
    engine at _DEVICE_DECODE_MBPS unless the link is slower (it moves the
    compressed stream up and the PCM down, ~1.6x PCM); the fast engine at
    _FAST_DECODE_MBPS unless the link is slower (residuals up and PCM down,
    ~2x PCM).  Small streams, and every stream on a CPU device (where the
    device engines run their kernels' plain versions), go to the host.
    `device` is the resolved device of the decode."""
    dev = torch.device(device)
    pcm_bytes = sum(f["blocksize"] * f["channels"] * 2 for f in frames)
    if pcm_bytes < _SMALL_STREAM_BYTES or dev.type == "cpu":
        return "host"
    bw = probe_link_bandwidth(dev)
    rates = {"host": _HOST_DECODE_MBPS_PER_CORE * min(os.cpu_count() or 1,
                                                      8),
             "device": min(_DEVICE_DECODE_MBPS, bw / 1.6),
             "fast": min(_FAST_DECODE_MBPS, bw / 2.0)}
    return max(rates, key=rates.get)


# ---------------------------------------------------------------------------
# Top-level decode
# ---------------------------------------------------------------------------

def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown decode engine {engine!r}")


def decode_frame_list(data: bytes, st: DecodedStream, frames: list, *,
                      device, verify_crc: bool = True,
                      max_batch: int = 1024,
                      on_crc_error: str = "raise",
                      engine: str = "device",
                      md5_hasher=None) -> list[np.ndarray]:
    """Batched decode of an explicit frame-header list (each entry needs
    offset/size/assignment/bps/channels/blocksize, as scan_frames gives
    them).  Returns per-frame [C, N] int32 arrays in list order.

    on_crc_error: "raise" aborts on the first bad frame; "drop" leaves the
    frame's slot as None and records its number in st.errors (the
    resync-and-continue behavior of stream_decoder.c:2476-2480).
    engine: "device", "fast", "host", "scan" or "auto" (module docstring);
    `device` is unused by "host".  md5_hasher is fed in stream order by
    "device", "fast" and "host".
    """
    _check_engine(engine)
    if not frames:
        return []
    device = resolve_device(device)
    if engine == "auto":
        engine = _pick_engine(frames, device)
    kw = dict(verify_crc=verify_crc, on_crc_error=on_crc_error)
    if engine == "device":
        return decode_frame_list_device(data, st, frames, device=device,
                                        max_batch=max_batch,
                                        md5_hasher=md5_hasher, **kw)
    if engine == "fast":
        return decode_frame_list_fast(data, st, frames, device=device,
                                      max_batch=max_batch,
                                      md5_hasher=md5_hasher, **kw)
    if engine == "host":
        return decode_frame_list_host(data, st, frames,
                                      md5_hasher=md5_hasher, **kw)
    return decode_frame_list_scan(data, st, frames, device=device,
                                  max_batch=max_batch, **kw)


def decode_frames_selected(data: bytes, st: DecodedStream, frames: list, *,
                           device=None) -> np.ndarray:
    """Decode a contiguous frame run and concatenate (the seek read
    path)."""
    return np.concatenate(decode_frame_list(data, st, frames, device=device),
                          axis=1)


def decode_stream_tpu(data: bytes, *, verify_md5: bool = True,
                      verify_crc: bool = True, max_batch: int = 1024,
                      tolerant: bool = False, engine: str = "device",
                      device=None) -> DecodedStream:
    """Full stream decode with batched subframe decoding.

    device: None means "cuda" (raises if no GPU is present, whatever the
    engine); pass "cpu" to run the engines on the CPU.  The name is the
    reference's (flac_tpu.decoder.decode_stream_tpu), so a reader finds its
    counterpart.  Raises FlacDecodeError on a corrupt stream and on an MD5
    mismatch.

    tolerant=True enables the reference's error recovery (`flac -F` and
    stream_decoder.c's resilience): a leading ID3v2 tag is skipped
    (:2299), streams without a fLaC marker or STREAMINFO decode
    (:2712-2718), a mid-stream first frame is accepted, bad frames are
    dropped (:2476-2480) and, like missing frames, concealed with silence
    (:2484-2520, at most 5 s or 50 frames a gap).  Recovered errors are
    listed in st.errors; an MD5 mismatch then sets st.md5_ok = False.
    """
    _check_engine(engine)
    device = resolve_device(device)
    head = skip_id3v2(data)
    if head and not tolerant:
        data = data[head:]
        head = 0
    if data[head:head + 4] == fmt.STREAM_SYNC_STRING:
        st, pos = parse_metadata(data, head + 4)
    elif tolerant:
        st = stream_params_from_frames(data, head)
        pos = head
    else:
        raise FlacDecodeError("missing fLaC marker")
    frames = scan_frames_tolerant(data, st, pos) if tolerant else \
        scan_frames(data, st, pos)
    st.frames = frames
    st.errors = []
    if not frames:
        st.samples = np.zeros((max(st.channels, 1), 0), np.int32)
        return st

    hasher = None
    if verify_md5 and not tolerant and st.md5 != b"\x00" * 16:
        hasher = StreamHasher(st.bits_per_sample)
    try:
        results = decode_frame_list(
            data, st, frames, device=device, verify_crc=verify_crc,
            max_batch=max_batch, on_crc_error="drop" if tolerant else "raise",
            engine=engine, md5_hasher=hasher)
    except FlacDecodeError:
        if tolerant:
            raise
        # strict-mode false-sync recovery: a payload byte pattern that
        # scans as a valid next header truncates the real frame; re-find
        # true frame extents by decode (stream_decoder.c:2443-2480's
        # decode-then-CRC16 rejection) and retry once
        repaired = repair_frame_table(data, st, frames)
        if repaired == frames:
            raise
        frames = st.frames = repaired
        hasher = None    # the first attempt's partial hash is stale
        results = decode_frame_list(
            data, st, frames, device=device, verify_crc=verify_crc,
            max_batch=max_batch, engine=engine)

    assembled = getattr(st, "_assembled", None)
    st._assembled = None
    if tolerant:
        st.samples = _assemble_with_concealment(st, frames, results)
    elif assembled is not None:
        st.samples = assembled          # the host engine decoded in place
    else:
        st.samples = np.concatenate(results, axis=1)
    if st.total_samples:
        st.samples = st.samples[:, :st.total_samples]
    st.md5_ok = True
    if verify_md5 and st.md5 != b"\x00" * 16:
        if (hasher is not None and hasher.valid
                and hasher.nframes == len(frames)
                and (not st.total_samples or st.total_samples
                     == sum(f["blocksize"] for f in frames))):
            got = hasher.digest()    # hashed in stream order during decode
        else:
            h = native.MD5()
            h.update_pcm(np.ascontiguousarray(st.samples),
                         st.bits_per_sample)
            got = h.digest()
        if got != st.md5:
            if not tolerant:
                raise FlacDecodeError("stream MD5 mismatch")
            st.md5_ok = False
            st.errors.append(("MD5_MISMATCH", None))
    return st


def _assemble_with_concealment(st: DecodedStream, frames: list,
                               results: list) -> np.ndarray:
    """Place decoded frames on the sample timeline; fill gaps (missing or
    dropped frames) with silence, capped like the reference at
    min(5 s, 50 frames) a gap (stream_decoder.c:2505-2520)."""
    C = frames[0]["channels"]
    rate = frames[0]["sample_rate"] or st.sample_rate
    pieces = []
    expected_start = None
    for f, sig in zip(frames, results):
        start = (f["number"] if f["variable"]
                 else f["number"] * frames[0]["blocksize"])
        if expected_start is None:
            expected_start = start
        if start > expected_start:
            gap = start - expected_start
            cap = min(5 * max(rate, 1), 50 * frames[0]["blocksize"])
            st.errors.append(("MISSING_FRAME", expected_start))
            pieces.append(np.zeros((C, min(gap, cap)), np.int32))
            expected_start = start
        pieces.append(np.zeros((C, f["blocksize"]), np.int32)
                      if sig is None else sig)     # dropped: concealed
        expected_start += f["blocksize"]
    return np.concatenate(pieces, axis=1)


def decode_stream_auto(data: bytes, **kw) -> DecodedStream:
    """Container-sniffing decode: native FLAC or Ogg FLAC by magic."""
    from .ogg import decode_ogg_flac, is_ogg
    if is_ogg(data):
        kw.pop("tolerant", None)    # Ogg layer has its own CRC resync
        return decode_ogg_flac(data, **kw)
    return decode_stream_tpu(data, **kw)
