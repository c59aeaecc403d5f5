"""The native (C++) host runtime of the decoder, bound with ctypes.

`flac_native.cpp` is the package's own copy of flac_tpu's host runtime,
changed in one place: the fused decode sends a frame with a 33-bit side
subframe to its int64 path at once (flac_tpu's restores it in int32 when
its residuals fit, and clips samples past 2^31).  It holds CRC-8/16
(crc.c), MD5 with the fused PCM interleave (md5.c:388-520), the frame-sync
scan (stream_decoder.c:2321, 2624), the full frame parse, the fused
all-CPU frame decode, and the tile skip-walk that feeds the GPU's Rice
decoder (`ops/bitunpack.py`, kernel `csrc/rice_codes.cu`).  Its segment
packing is the one that kernel decodes.

It also holds the host restore of a parsed batch, the encoder's ordered
frame gather (stream_encoder.c:3614-3626) and the ReplayGain filter's
direct-form IIR (replaygain_analysis.c:258-297).

The library is built with `g++ -O3 -shared -fPIC -std=c++17` at first use,
never at import, into `flac_tpu_torch/build/` (listed in .gitignore), named
by a hash of the source and the flags and moved into place atomically, so
concurrent first uses in several processes agree.  A failed build raises
with the compiler's output: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "flac_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 5     # must match FT_ABI_VERSION in flac_native.cpp

_lib = None
_lock = threading.Lock()


def build(force: bool = False) -> Path:
    """Compile the runtime unless this source was built before (or always,
    with force=True); returns the library's path.  Raises with g++'s output
    on failure.  `python -m flac_tpu_torch.native` calls it."""
    digest = hashlib.sha1(SRC.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libflac_native-{digest[:12]}.so"
    if force or not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError("g++ failed for flac_tpu_torch/native/"
                               f"flac_native.cpp:\n{out.stdout}")
        os.replace(tmp, lib)      # atomic: concurrent builds agree
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ft_abi_version.restype = ctypes.c_int32
    lib.ft_abi_version.argtypes = []
    lib.ft_crc8.restype = ctypes.c_uint8
    lib.ft_crc8.argtypes = [u8p, ctypes.c_int64]
    lib.ft_crc16.restype = ctypes.c_uint16
    lib.ft_crc16.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint16]
    lib.ft_md5_ctx_size.restype = ctypes.c_int32
    lib.ft_md5_ctx_size.argtypes = []
    lib.ft_md5_init.restype = None
    lib.ft_md5_init.argtypes = [ctypes.c_void_p]
    lib.ft_md5_update.restype = None
    lib.ft_md5_update.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.ft_md5_update_pcm.restype = None
    lib.ft_md5_update_pcm.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32]
    lib.ft_md5_final.restype = None
    lib.ft_md5_final.argtypes = [ctypes.c_void_p, u8p]
    lib.ft_scan_frames.restype = ctypes.c_int64
    lib.ft_scan_frames.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i64p, ctypes.c_int64]
    lib.ft_parse_frames.restype = ctypes.c_int64
    lib.ft_parse_frames.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p,
        ctypes.c_void_p, ctypes.c_void_p, i64p, i32p]
    lib.ft_tile_scan.restype = ctypes.c_int64
    lib.ft_tile_scan.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, i64p, i32p, i64p, i32p, i32p, i32p,
        i32p]
    lib.ft_decode_frames.restype = ctypes.c_int64
    lib.ft_decode_frames.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, ctypes.c_int32, ctypes.c_int32, i32p, i64p, ctypes.c_int64,
        i64p, i32p]
    for name, res_p in (("ft_restore", i32p), ("ft_restore_wide", i64p)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [res_p, i32p, i32p, i32p, i32p,
                       ctypes.c_int64, ctypes.c_int64, i64p]
    lib.ft_gather_frames.restype = ctypes.c_int64
    lib.ft_gather_frames.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                     i64p, u8p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ft_iir.restype = None
    lib.ft_iir.argtypes = [f64p, f64p, ctypes.c_int64, f64p, f64p,
                           ctypes.c_int32]


def lib() -> ctypes.CDLL:
    """The loaded runtime, built and bound on first use (thread-safe: the
    device engine's tile scans run on a worker pool)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            _bind(handle)
            abi = int(handle.ft_abi_version())
            if abi != ABI_VERSION:
                raise RuntimeError(f"flac_native: the library reports ABI "
                                   f"{abi}, the bindings need {ABI_VERSION}")
            _lib = handle
    return _lib


def _u8(buf):
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, np.uint8)
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_array(data) -> np.ndarray:
    return data if isinstance(data, np.ndarray) else \
        np.frombuffer(data, np.uint8)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def crc8(data: bytes) -> int:
    return lib().ft_crc8(_u8(data), len(data))


def crc16(data: bytes, init: int = 0) -> int:
    return lib().ft_crc16(_u8(data), len(data), init)


class MD5:
    """Streaming MD5 with a fused FLAC PCM interleave path."""

    def __init__(self):
        self._lib = lib()
        self._ctx = ctypes.create_string_buffer(self._lib.ft_md5_ctx_size())
        self._lib.ft_md5_init(self._ctx)

    def update(self, data: bytes) -> None:
        self._lib.ft_md5_update(self._ctx, _u8(data), len(data))

    def update_pcm(self, pcm: np.ndarray, bps: int) -> None:
        """pcm: [C, N] int32 with contiguous rows (any channel stride, so
        spans of a larger [C, total] array hash in place); hashes the FLAC
        MD5 byte stream (sample-major, little-endian, (bps+7)//8 bytes
        per sample)."""
        if pcm.dtype != np.int32 or pcm.strides[1] != 4:
            pcm = np.ascontiguousarray(pcm, np.int32)
        C, N = pcm.shape
        self._lib.ft_md5_update_pcm(self._ctx, _p32(pcm), C, N,
                                    pcm.strides[0] // 4, (bps + 7) // 8)

    def digest(self) -> bytes:
        # finalize a copy so the accumulator can keep going
        ctx = ctypes.create_string_buffer(self._ctx.raw, len(self._ctx))
        out = (ctypes.c_uint8 * 16)()
        self._lib.ft_md5_final(ctx, out)
        return bytes(out)


_SCAN_FIELDS = ("offset", "number", "blocksize", "sample_rate", "channels",
                "assignment", "bps", "variable", "header_bits")


def scan_frames(data: bytes, start: int, stream_bps: int,
                stream_rate: int) -> list[dict]:
    """Native frame-sync scan; returns header dicts with `header_end_bits`
    (the caller fills in `size`)."""
    arr = _as_array(data)
    max_frames = max(16, len(arr) // 10)
    out = np.empty((max_frames, 9), np.int64)
    n = lib().ft_scan_frames(_u8(arr), len(arr), start, stream_bps,
                             stream_rate, _p64(out), max_frames)
    frames = []
    for row in out[:n]:
        d = dict(zip(_SCAN_FIELDS, (int(v) for v in row)))
        d["header_end_bits"] = d["offset"] * 8 + d.pop("header_bits")
        frames.append(d)
    return frames


# Frame parse/restore status codes (mirror flac_native.cpp's enum)
FT_OK = 0
FT_PARSE_ERR = 1
FT_CRC16_BAD = 2
FT_RES_OVERFLOW = 3
FT_EXTENT_MISMATCH = 4
FT_OOR = 5
FT_SEG_OVERFLOW = 6

SEG_INERT = (255 << 7) | 1      # raw width-0 x255: the idle segment


def _frame_table(offsets, start_bits, sizes, ch_bps):
    return (np.ascontiguousarray(offsets, np.int64),
            np.ascontiguousarray(start_bits, np.int64),
            np.ascontiguousarray(sizes, np.int64),
            np.ascontiguousarray(ch_bps, np.int32))


class TileGroup:
    """ft_tile_scan output: per-subframe restore metadata and per-lane
    segment tables for the GPU's Rice decoder (ops/bitunpack.py)."""

    __slots__ = ("order", "shift", "wasted", "sftype", "qlp", "lane_start",
                 "segs", "end_bits", "status", "wide", "max_tile_bits",
                 "max_segs", "tiles")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def tile_scan(data, offsets, start_bits, sizes, ch_bps, blocksize: int,
              T: int = 128, segmax: int = 8) -> TileGroup:
    """Skip-walk F same-shape frames, emitting the tile tables of the GPU
    decode: per lane (T samples of one subframe) its start bit and its
    {skip, count, param, kind} segments.  No residual touches the host."""
    arr = _as_array(data)
    offsets, start_bits, sizes, ch_bps = _frame_table(offsets, start_bits,
                                                      sizes, ch_bps)
    F, C = ch_bps.shape
    S = F * C
    tiles = (blocksize + T - 1) // T
    order = np.zeros(S, np.int32)
    shift = np.zeros(S, np.int32)
    wasted = np.zeros(S, np.int32)
    sftype = np.zeros(S, np.int32)
    qlp = np.zeros((S, 32), np.int32)
    lane_start = np.zeros(S * tiles, np.int64)
    segs = np.full((S * tiles, segmax), SEG_INERT, np.int32)
    end_bits = np.zeros(F, np.int64)
    status = np.zeros(F, np.int32)
    wide = np.zeros(F, np.int32)
    max_tile_bits = np.zeros(1, np.int32)
    max_segs = np.zeros(1, np.int32)
    lib().ft_tile_scan(
        _u8(arr), len(arr), _p64(offsets), _p64(start_bits), _p64(sizes),
        _p32(ch_bps), F, C, blocksize, T, segmax,
        _p32(order), _p32(shift), _p32(wasted), _p32(sftype), _p32(qlp),
        _p64(lane_start), _p32(segs), _p64(end_bits), _p32(status),
        _p32(wide), _p32(max_tile_bits), _p32(max_segs))
    return TileGroup(order=order, shift=shift, wasted=wasted, sftype=sftype,
                     qlp=qlp, lane_start=lane_start, segs=segs,
                     end_bits=end_bits, status=status, wide=wide,
                     max_tile_bits=int(max_tile_bits[0]),
                     max_segs=int(max_segs[0]), tiles=tiles)


def decode_frames_full(data, offsets, start_bits, sizes, ch_bps,
                       blocksize: int, assignment, check_bps: int = 0,
                       verify_crc: bool = True, out=None, out_off=None):
    """Fused all-CPU frame decode: parse, restore, stereo undo and range
    check in one native pass (the host engine's loop).

    With out=None returns (pcm [F, C, N] int32, end_bits, status); with
    out (a [C, total] int32 array with contiguous rows) and out_off (per-
    frame sample offsets) the frames decode straight into it and pcm is
    returned as None.  check_bps enables the stream_decoder.c:2458-2472
    bps-range rejection (status FT_OOR).  ctypes releases the GIL, so
    chunks of the frame table decode in parallel on a thread pool.
    """
    arr = _as_array(data)
    offsets, start_bits, sizes, ch_bps = _frame_table(offsets, start_bits,
                                                      sizes, ch_bps)
    assignment = np.ascontiguousarray(assignment, np.int32)
    F, C = ch_bps.shape
    end_bits = np.zeros(F, np.int64)
    status = np.zeros(F, np.int32)
    if out is None:
        dest = np.empty((F, C, blocksize), np.int32)
        off_p, stride = None, 0
    else:
        if out.dtype != np.int32 or out.strides[1] != 4:
            raise ValueError("decode_frames_full: out must be int32 with "
                             "contiguous rows")
        dest = out
        out_off = np.ascontiguousarray(out_off, np.int64)
        off_p, stride = _p64(out_off), out.strides[0] // 4
    lib().ft_decode_frames(
        _u8(arr), len(arr), _p64(offsets), _p64(start_bits), _p64(sizes),
        _p32(ch_bps), F, C, blocksize, _p32(assignment), check_bps,
        int(verify_crc), _p32(dest), off_p, stride, _p64(end_bits),
        _p32(status))
    return (dest if out is None else None), end_bits, status


class ParsedGroup:
    """Full-parse output for a batch of same-shape frames, in the uniform
    LPC restore form (see flac_native.cpp ft_parse_frames)."""

    __slots__ = ("order", "shift", "wasted", "sftype", "qlp", "res",
                 "end_bits", "status", "wide")

    def __init__(self, order, shift, wasted, sftype, qlp, res, end_bits,
                 status, wide):
        self.order = order          # [S] int32
        self.shift = shift          # [S] int32
        self.wasted = wasted        # [S] int32
        self.sftype = sftype        # [S] int32 (0 const,1 verb,2 fixed,3 lpc)
        self.qlp = qlp              # [S, 32] int32 (normalized taps)
        self.res = res              # [S, N] int32 (or int64 when wide)
        self.end_bits = end_bits    # [F] int64 absolute bit cursor
        self.status = status        # [F] int32 FT_* codes
        self.wide = wide


def parse_frames(data, offsets, start_bits, sizes, ch_bps,
                 blocksize: int, wide: bool = False) -> ParsedGroup:
    """Bit-walk F same-shape frames, emitting per-subframe (order, shift,
    wasted, qlp, residual) in the uniform restore form plus a CRC-16 and
    extent status per frame.  Retries in wide (int64 residual) mode if any
    frame overflows int32."""
    arr = _as_array(data)
    offsets, start_bits, sizes, ch_bps = _frame_table(offsets, start_bits,
                                                      sizes, ch_bps)
    F, C = ch_bps.shape
    S = F * C
    order = np.zeros(S, np.int32)
    shift = np.zeros(S, np.int32)
    wasted = np.zeros(S, np.int32)
    sftype = np.zeros(S, np.int32)
    qlp = np.zeros((S, 32), np.int32)
    res = np.zeros((S, blocksize), np.int64 if wide else np.int32)
    end_bits = np.zeros(F, np.int64)
    status = np.zeros(F, np.int32)
    lib().ft_parse_frames(
        _u8(arr), len(arr), _p64(offsets), _p64(start_bits), _p64(sizes),
        _p32(ch_bps), F, C, blocksize,
        _p32(order), _p32(shift), _p32(wasted), _p32(sftype), _p32(qlp),
        None if wide else res.ctypes.data, res.ctypes.data if wide else None,
        _p64(end_bits), _p32(status))
    if not wide and np.any(status == FT_RES_OVERFLOW):
        return parse_frames(data, offsets, start_bits, sizes, ch_bps,
                            blocksize, wide=True)
    return ParsedGroup(order, shift, wasted, sftype, qlp, res, end_bits,
                       status, wide)


def restore_subframes(pg: ParsedGroup) -> np.ndarray:
    """Host restore of a ParsedGroup -> [S, N] int64 subframe signals with
    the wasted bits applied (int64 history: the 33-bit side fits)."""
    S, N = pg.res.shape
    out = np.empty((S, N), np.int64)
    fn = lib().ft_restore_wide if pg.wide else lib().ft_restore
    res = np.ascontiguousarray(pg.res, np.int64 if pg.wide else np.int32)
    fn((_p64 if pg.wide else _p32)(res), _p32(pg.order), _p32(pg.shift),
       _p32(pg.wasted), _p32(pg.qlp), S, N, _p64(out))
    return out


def gather_frames(rows: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate the first lens[i] bytes of each row (the ordered frame
    gather)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    if rows.ndim != 2 or len(lens) != rows.shape[0] or (
            len(lens) and (lens.min() < 0 or lens.max() > rows.shape[1])):
        raise ValueError("gather_frames: lens must be one length in "
                         "[0, row bytes] a row")
    out = np.empty(int(lens.sum()), np.uint8)
    lib().ft_gather_frames(_u8(rows), rows.shape[0], rows.shape[1],
                           _p64(lens), _u8(out))
    return out.tobytes()


def iir_filter(x: np.ndarray, b: np.ndarray, a: np.ndarray,
               x_hist: np.ndarray, y_hist: np.ndarray):
    """Direct-form IIR with explicit history (the ReplayGain filter
    cascade).

    x: [n] float64; b, a: [order+1] coefficients (a[0] ignored, == 1);
    x_hist, y_hist: [order] trailing history from the previous call
    (oldest first).  Returns (y [n], new_x_hist, new_y_hist).
    """
    order = len(b) - 1
    n = len(x)
    xp = np.concatenate([x_hist[-order:] if order else x_hist, x]
                        ).astype(np.float64)
    yp = np.empty(order + n, np.float64)
    yp[:order] = y_hist[-order:]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib().ft_iir(xp[order:].ctypes.data_as(f64p),
                 yp[order:].ctypes.data_as(f64p), n,
                 np.ascontiguousarray(b, np.float64).ctypes.data_as(f64p),
                 np.ascontiguousarray(a, np.float64).ctypes.data_as(f64p),
                 order)
    if n >= order:
        return yp[order:], xp[-order:].copy(), yp[-order:].copy()
    return (yp[order:], np.concatenate([x_hist, x])[-order:],
            yp[-order:].copy())
