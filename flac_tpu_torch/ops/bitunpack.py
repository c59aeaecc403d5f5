"""Device Rice decoder: the code scan (kernel K2) and the batched restore.

Port of flac_tpu/ops/bitunpack.py.  The host tile skip-walk
(native.tile_scan) finds WHERE codes live: each subframe's N samples split
into tiles of T samples, and each tile becomes one lane with a start bit
and a short table of segments {skip, count, param, kind}.  On the device:

  1. the code scan decodes T codes per lane, one per step: pop the next
     segment when the current one is spent, take the 64-bit window at the
     bit cursor, count the unary run with clz in two stages (runs of 128
     zeros or more flag the lane), read the k-bit tail and unfold the
     zigzag; raw segments give sign-extended fixed-width values, width 0
     gives zeros.  `rice_codes_plain` is its plain PyTorch version (the
     XLA-scan branch of the reference, steps 1-2); `rice_cuda.rice_codes`
     launches the hand-written kernel for CUDA tensors;
  2. the lanes reshape to the [S, N] residual matrix (tiles are contiguous
     sample ranges) and the uniform LPC restore, the wasted-bit shift and
     the stereo undo run over every subframe at once: `restore_undo_body`
     is their plain version (the reference's XLA scan, as an eager loop);
     `restore_cuda.restore_undo` launches the hand-written kernel K3 for
     CUDA tensors.

dtype policy: stream words are uint32 carried in int64 in [0, 2^32) (or
their bits as int32); 32-bit shifts follow XLA's rule that a shift at or
above the width gives 0.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import format as fmt
from . import bitops, restore_cuda, rice_cuda

# segment packing (must mirror flac_native.cpp tile_run):
#   int32 = skip:16 @15 | count:8 @7 | param:6 @1 | kind:1 @0
SEG_INERT = (255 << 7) | (0 << 1) | 1      # raw width-0 x255: idle padding

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Restore + stereo undo
# ---------------------------------------------------------------------------

def restore_undo_body(res, order, shift, qlp, wasted, assignment, *,
                      blocksize: int, channels: int, max_order: int,
                      wide: bool = False, out16: bool = False, bps: int = 0):
    """Uniform batched subframe restore + stereo undo (lpc.c:978 and
    stream_decoder.c:3476-3526, one sample loop over all subframes): kernel
    K3's plain version.

    res: [S, N] residuals (int16/int32, int64 when wide); order/shift/
    wasted: [S]; qlp: [S, >= max_order]; assignment: [B] (S = B*channels).
    Returns ([B, channels, N] PCM, [B] bool out-of-range flags computed
    BEFORE any narrowing; bps=0 disables the range check).  Narrow streams
    compute in int32 with wrap-around, as the reference does.
    """
    S = res.shape[0]
    N = blocksize
    mo = max_order
    xdt = torch.int64 if wide else torch.int32
    r = res.to(xdt)
    # x[:, mo + n] is sample n; the mo leading zeros are the empty history
    x = torch.zeros((S, mo + N), dtype=torch.int64, device=res.device)
    if mo:
        taps = qlp[:, :mo].flip(1).to(torch.int64)   # pairs with x[n-mo..n)
        sh = shift.to(torch.int64)
        omax = int(order.max()) if S else 0
        for n in range(N):
            acc = (x[:, n:n + mo] * taps).sum(1)
            xn = r[:, n] + (acc >> sh).to(xdt)
            if n < omax:              # warm-up samples pass through
                xn = torch.where(order > n, r[:, n], xn)
            x[:, mo + n] = xn
    else:
        x[:, mo:] = r
    x = x[:, mo:].to(xdt) << wasted[:, None].to(xdt)

    sig = x.reshape(-1, channels, N)
    if channels == 2:
        a, b = sig[:, 0], sig[:, 1]
        asg = assignment[:, None]
        mid = (a << 1) | (b & 1)
        left = torch.where(
            asg == fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE, b + a,
            torch.where(asg == fmt.CHANNEL_ASSIGNMENT_MID_SIDE,
                        (mid + b) >> 1, a))
        right = torch.where(
            asg == fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE, a - b,
            torch.where(asg == fmt.CHANNEL_ASSIGNMENT_MID_SIDE,
                        (mid - b) >> 1, b))
        sig = torch.stack([left, right], dim=1)
    if bps:
        lim = 1 << (bps - 1)
        s64 = sig.to(torch.int64)
        oor = ((s64 < -lim) | (s64 >= lim)).flatten(1).any(1)
    else:
        oor = torch.zeros((sig.shape[0],), dtype=torch.bool,
                          device=sig.device)
    if out16:
        return sig.to(torch.int16), oor
    return sig, oor


# ---------------------------------------------------------------------------
# The code scan, plain version
# ---------------------------------------------------------------------------

def _shl32(x, s):
    """uint32 x << s (x in [0, 2^32) in int64), 0 for s >= 32."""
    return torch.where(s >= 32, 0, (x << s.clamp(0, 31)) & _MASK32)


def _shr32(x, s):
    """uint32 x >> s (x in [0, 2^32) in int64), 0 for s >= 32."""
    return torch.where(s >= 32, 0, x >> s.clamp(0, 31))


def _wrap32(x):
    """int64 -> the int32 value with the same low 32 bits."""
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def _extractor(win):
    """A 64-bit window extractor over win [L, W] (uint32 in int64).

    Returns extract(cur [L] int64 bit offsets) -> (hi, lo), the uint32 pair
    holding bits [cur, cur+64) MSB-first.  Words outside [0, W) read as 0,
    as the reference's one-hot word selection gives."""
    W = win.shape[1]
    k3 = torch.arange(3, device=win.device)

    def extract(cur):
        idx = (cur >> 5)[:, None] + k3
        inside = (idx >= 0) & (idx < W)
        w = torch.where(inside, torch.gather(win, 1, idx.clamp(0, W - 1)), 0)
        w0, w1, w2 = w.unbind(1)
        off = cur & 31
        sh2 = (32 - off) & 31                    # safe when off == 0
        pos = off > 0
        hi = torch.where(pos, ((w0 << off) | (w1 >> sh2)) & _MASK32, w0)
        lo = torch.where(pos, ((w1 << off) | (w2 >> sh2)) & _MASK32, w1)
        return hi, lo

    return extract


def _clz32(v):
    """Leading zeros of uint32 values (in int64): frexp's exponent of an
    exactly converted value is its bit length (0 for 0)."""
    return 32 - torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def _clz64(hi, lo):
    """Count leading zeros of the (hi, lo) uint32 pair (0..64)."""
    return torch.where(hi != 0, _clz32(hi), 32 + _clz32(lo))


def rice_codes_plain(words2d, lane_start, segs, *, T: int, NROW: int,
                     SEG: int, wide: bool):
    """Kernel K2's plain version: the row-blocked window gather and the
    T-step code scan (flac_tpu/ops/bitunpack.py:353-357, 373-476).

    words2d:    [R, 16] the stream as big-endian words (uint32 in int64, or
                their bits in int32), in aligned 16-word rows
    lane_start: [L] absolute bit offset of each lane's first segment
    segs:       [L, >= SEG] int32 packed segment tables; a lane that spends
                its SEG slots reads segment 0 (Rice, parameter 0, count 0)
    Returns (res [T, L] int32, int64 when wide; ovf [L] bool): ovf flags
    lanes whose unary run reached 128 bits or ran past the window's
    NROW * 512 bits.
    """
    dev = lane_start.device
    L = lane_start.shape[0]
    words = words2d.to(torch.int64) & _MASK32
    R = words.shape[0]
    ls = lane_start.to(torch.int64)
    # 1. window gather: NROW aligned 16-word rows from the lane's 512-bit
    # granule (rows past the end read the last row, as XLA's gather clamps)
    base_row = ls >> 9
    ridx = (base_row[:, None] + torch.arange(NROW, device=dev)).clamp(0, R - 1)
    win = words[ridx].reshape(L, NROW * 16)
    extract = _extractor(win)
    max_bits = NROW * 512
    seg_tab = segs[:, :SEG].to(torch.int64)

    cur = ls - (base_row << 9)
    seg_i = torch.full((L,), -1, dtype=torch.int64, device=dev)
    rem = torch.zeros((L,), dtype=torch.int64, device=dev)
    param = torch.zeros_like(rem)
    kind = torch.zeros_like(rem)
    ovf = torch.zeros((L,), dtype=torch.bool, device=dev)
    vals = []
    # 2. one code per lane per step
    for _ in range(T):
        adv = rem == 0
        seg_i = seg_i + adv
        pk = torch.where(seg_i < SEG, torch.gather(
            seg_tab, 1, seg_i.clamp(0, SEG - 1)[:, None])[:, 0], 0)
        cur = torch.where(adv, cur + ((pk >> 15) & 0xFFFF), cur)
        rem = torch.where(adv, (pk >> 7) & 0xFF, rem)
        param = torch.where(adv, (pk >> 1) & 0x3F, param)
        kind = torch.where(adv, pk & 1, kind)

        hi, lo = extract(cur)
        is_raw = kind == 1
        pos = param > 0
        # shift amounts pre-clamped, as the reference's
        sh32 = torch.where(pos, 32 - param.clamp(max=32), 0)
        pm1 = torch.where(pos, param - 1, 0)

        # raw value: top `param` bits, sign-extended (width 0 -> 0)
        if wide:
            w64 = (hi << 32) | lo
            rv = torch.where(pos, bitops.srl64(w64, torch.where(
                pos, 64 - param, 0)), 0)
            sgn = torch.where(pos, bitops.srl64(rv, pm1) & 1, 0)
            raw_val = rv - (sgn << param)
        else:
            rv = torch.where(pos, hi >> sh32, 0)
            sgn = torch.where(pos, _shr32(rv, pm1) & 1, 0)
            sgn_term = torch.where(pos, _shl32(sgn, pm1), 0)
            raw_val = _wrap32(rv - 2 * sgn_term)

        # unary: clz over the 64-bit window, a second stage for runs of
        # 64..127 zeros; longer runs flag the lane
        nz0 = _clz64(hi, lo)
        hi2, lo2 = extract(cur + 64)
        nz1 = _clz64(hi2, lo2)
        more = ~is_raw & (nz0 >= 64)
        q = torch.where(more, 64 + nz1.clamp(max=64), nz0)
        cq = cur + q
        ovf = ovf | (~is_raw & ((more & (nz1 >= 64)) | (cq > max_bits)))

        # k-bit tail after the stop bit
        thi, _ = extract(cq + 1)
        lsb = torch.where(pos, thi >> sh32, 0)
        if wide:
            u = (q << param) | lsb
            rice_val = bitops.srl64(u, torch.ones_like(u)) ^ -(u & 1)
        else:
            u = _shl32(q, param) | lsb
            rice_val = (u >> 1) ^ -(u & 1)

        vals.append(torch.where(is_raw, raw_val, rice_val))
        cur = torch.where(is_raw, cur + param, cq + 1 + param)
        rem = rem - 1
    res = torch.stack(vals) if vals else torch.zeros(
        (0, L), dtype=torch.int64, device=dev)
    return res.to(torch.int64 if wide else torch.int32), ovf


# ---------------------------------------------------------------------------
# The fused decode of one batch
# ---------------------------------------------------------------------------

def rice_decode_restore(words2d, lane_start, segs, order, shift, qlp,
                        wasted, assignment, *, T: int, NROW: int, SEG: int,
                        blocksize: int, channels: int, max_order: int,
                        wide: bool = False, out16: bool = False, bps: int = 0):
    """Code scan (K2) + LPC restore and stereo undo (K3) of one batch.

    words2d:    [R, 16] the stream as big-endian words in aligned 16-word
                rows (64-byte granules), uint32 bits in int32 or int64
    lane_start: [L] int32 absolute bit offset of each lane's first segment
                (L = S * ceil(N/T), S = B*channels)
    segs:       [L, SEG] int32 packed segment tables (native.tile_scan)
    order/shift/wasted: [S]; qlp: [S, max_order]; assignment: [B]
    Returns (pcm [B, C, N], oor [B] bool, lane_ovf [L] bool).  lane_ovf
    flags lanes whose unary run overran the window (corrupt or
    pathological input; the caller re-decodes those frames on the host).
    """
    L = lane_start.shape[0]
    S = order.shape[0]
    tiles = L // S
    with record_function("flac.codes"):
        res_tl, lane_ovf = rice_cuda.rice_codes(
            words2d, lane_start, segs, T=T, NROW=NROW, SEG=SEG, wide=wide)
    with record_function("flac.restore"):
        # lanes -> residual matrix (a reshape: tiles tile the samples)
        res = res_tl.t().reshape(S, tiles * T)[:, :blocksize]
        pcm, oor = restore_cuda.restore_undo(
            res, order, shift, qlp, wasted, assignment, blocksize=blocksize,
            channels=channels, max_order=max_order, wide=wide, out16=out16,
            bps=bps)
    return pcm, oor, lane_ovf
