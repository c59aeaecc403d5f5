"""Batched FLAC decode: the host frame scan, then a decode engine.

Port of the device-engine path of flac_tpu/decoder.py.  The host finds
frame boundaries (byte-aligned sync codes, CRC-8-verified headers and the
sequential-number invariant, in the native runtime) and hands the frame
table to an engine:

  "device" (the default): the native tile skip-walk on the host and the
      Rice code scan (kernel K2), restore and stereo undo on the device
      (decoder_device.py);
  "host":   the fused all-CPU native decoder (decoder_fast.py).

Not ported yet, each raising NotImplementedError: the "fast" engine
(native full parse + device restore), the "scan" engine (the all-device
per-sample oracle), "auto" (the engine policy, to be rebuilt from H100
measurements) and tolerant=True decoding.
"""

from __future__ import annotations

import numpy as np

from . import format as fmt
from . import native
from .decoder_device import decode_frame_list_device
from .decoder_fast import StreamHasher, decode_frame_list_host, \
    repair_frame_table
from .device import resolve_device
from .ref_decoder import DecodedStream, FlacDecodeError, parse_metadata

ENGINES = ("device", "host")
_NOT_PORTED = ("fast", "scan", "auto")


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


def scan_frames(data: bytes, st: DecodedStream, start: int):
    """Locate all frames with the native sync scan; returns header dicts
    with 'size' filled in.  False sync patterns inside frame payloads are
    rejected by requiring consecutive frame/sample numbers (the
    fixed-blocksize stream invariant, format.h:403-406)."""
    frames = native.scan_frames(data, start, st.bits_per_sample,
                                st.sample_rate)
    for i, f in enumerate(frames):
        end = frames[i + 1]["offset"] if i + 1 < len(frames) else len(data)
        f["size"] = end - f["offset"]
    return frames


def _check_engine(engine: str) -> None:
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"flac_tpu_torch: the {engine!r} decode engine is not ported "
            "yet; use 'device' or 'host'")
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
    engine: "device" (tile skip-walk + K2 + restore on `device`) or
    "host" (the all-CPU engine; `device` is unused).
    """
    _check_engine(engine)
    if not frames:
        return []
    if engine == "device":
        return decode_frame_list_device(
            data, st, frames, device=device, verify_crc=verify_crc,
            max_batch=max_batch, on_crc_error=on_crc_error,
            md5_hasher=md5_hasher)
    return decode_frame_list_host(
        data, st, frames, verify_crc=verify_crc, on_crc_error=on_crc_error,
        md5_hasher=md5_hasher)


def decode_stream_tpu(data: bytes, *, verify_md5: bool = True,
                      verify_crc: bool = True, max_batch: int = 1024,
                      tolerant: bool = False, engine: str = "device",
                      device=None) -> DecodedStream:
    """Full stream decode with batched subframe decoding.

    device: None means "cuda" (raises if no GPU is present); pass "cpu" to
    run the device engine on the CPU.  The name is the reference's
    (flac_tpu.decoder.decode_stream_tpu), so a reader finds its
    counterpart.  Raises FlacDecodeError on a corrupt stream and on an MD5
    mismatch.
    """
    if tolerant:
        raise NotImplementedError(
            "flac_tpu_torch: tolerant decoding is not ported yet")
    _check_engine(engine)
    device = resolve_device(device)
    head = skip_id3v2(data)
    if head:
        data = data[head:]
    if data[:4] != fmt.STREAM_SYNC_STRING:
        raise FlacDecodeError("missing fLaC marker")
    st, pos = parse_metadata(data, 4)
    frames = scan_frames(data, st, pos)
    st.frames = frames
    st.errors = []
    if not frames:
        st.samples = np.zeros((max(st.channels, 1), 0), np.int32)
        return st

    hasher = None
    if verify_md5 and st.md5 != b"\x00" * 16:
        hasher = StreamHasher(st.bits_per_sample)
    try:
        results = decode_frame_list(
            data, st, frames, device=device, verify_crc=verify_crc,
            max_batch=max_batch, engine=engine, md5_hasher=hasher)
    except FlacDecodeError:
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

    if getattr(st, "_assembled", None) is not None:
        st.samples = st._assembled      # the host engine decoded in place
        st._assembled = None
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
            raise FlacDecodeError("stream MD5 mismatch")
    return st
