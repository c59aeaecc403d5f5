"""Synthetic lane tables for holding the Rice code scan (kernel K2) against
its plain version, and the plain version against the reference.

`synthetic_lanes` writes a bitstream with the package's BitWriter and the
matching lane tables: Rice parameters 0-30, unary runs of 0-63, 64-127
(the second clz stage) and 128 or more (overflow), raw widths 0-32 (0-63
for wide lanes), escape-like mixes of Rice and raw segments, a lane that
runs past its window, a lane that spends all of its segment slots, a
segment of count 0, partial tiles idled by the inert segment, and, for
wide tables, values of 2^32 and more.  Random skips sit before every
segment and random gaps between lanes, so lanes start at any bit.

`staging_lanes` lays lanes out for the CTAs of K2's Hopper design (CTAs of
CTA_LANES lanes that stage their windows' rows in shared memory, and
decode from a bit reservoir): a CTA in stream order, one in reverse stream
order, one whose lanes span more than a CTA may stage (it reads global
memory), and a partial last CTA whose staged span runs past the last row
of the stream; with codes that straddle the reservoir's refills, unary
runs of 31, 32, 63, 64 and more at every bit alignment, and segment skips
of 60,000 bits and more inside a window.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitWriter
from .bitunpack import SEG_INERT
from .rice_cuda import STAGE_LANES as CTA_LANES     # lanes a K2 CTA

T = 128          # codes per lane, as the decoder's tiles
NROW = 8         # window rows: 4096 bits
SEG = 8          # segment slots per lane
_BUDGET = 3000   # bits a well-formed lane may use inside its window
STAGING_NROW = 128   # window rows of staging_lanes: 65,536 bits


def _pack(skip: int, count: int, param: int, kind: int) -> int:
    return (skip << 15) | (count << 7) | (param << 1) | kind


def _garbage(bw: BitWriter, rng, n: int) -> None:
    """n random bits."""
    while n > 0:
        b = min(n, 60)
        bw.write(int(rng.integers(0, 1 << b)), b)
        n -= b


def _rice(rng, k: int, qs):
    """(kind, param, codes) of Rice codes with unary runs qs: each code is
    (q, lsb), the folded value being q << k | lsb."""
    return 0, k, [(int(q), int(rng.integers(0, 1 << k)) if k else 0)
                  for q in qs]


def _raw(rng, width: int, count: int):
    vals = [int(rng.integers(0, 1 << width)) if width else 0
            for _ in range(count)]
    return 1, width, vals


def _lanes(rng, wide: bool):
    """Each lane: a list of segments (kind, param, codes[, skip]), at most
    SEG - 1 of them and T codes unless the case is about overflowing
    either; a segment without a skip gets a random one."""
    lanes = []
    for k in range(31):                                  # Rice params 0-30
        n = min(T, _BUDGET // (k + 9))
        lanes.append([_rice(rng, k, rng.integers(0, 8, n))])
    lanes.append([_rice(rng, 2, rng.integers(0, 64, 40))])     # runs 0-63
    lanes.append([_rice(rng, 1, rng.integers(64, 128, 20))])   # 64-127
    lanes.append([_rice(rng, 0, [63, 64, 127, 5])])            # stage edges
    lanes.append([_rice(rng, 3, [1, 2, 128, 4])])              # 128: ovf
    lanes.append([_rice(rng, 0, [200, 1])])                    # >128: ovf
    for w in range(33):                                  # raw widths 0-32
        lanes.append([_raw(rng, w, min(T, _BUDGET // max(w, 1)))])
    lanes.append([_rice(rng, 5, rng.integers(0, 6, 20)),       # escapes
                  _raw(rng, 12, 20), _rice(rng, 0, rng.integers(0, 4, 20)),
                  _raw(rng, 0, 20), _rice(rng, 14, rng.integers(0, 3, 20)),
                  _raw(rng, 32, 20)])
    # past its window: 2000 skipped bits, then 128 codes of 29+ bits
    lanes.append([(*_rice(rng, 28, rng.integers(0, 12, T)), 2000)])
    lanes.append([_rice(rng, 3, rng.integers(0, 5, 10))       # all slots
                  for _ in range(SEG)])
    lanes.append([_rice(rng, 4, rng.integers(0, 9, 80))])      # partial tile
    lanes.append([_rice(rng, 6, rng.integers(0, 4, 30)),       # count 0
                  (0, 9, []), _raw(rng, 7, 30)])
    if wide:
        for w in list(range(33, 41)) + [48, 63]:         # raw widths > 32
            lanes.append([_raw(rng, w, min(T, _BUDGET // w))])
        lanes.append([_rice(rng, 30, rng.integers(0, 64, 40))])  # u >= 2^32
        lanes.append([_raw(rng, 33, 30), _rice(rng, 29, rng.integers(
            4, 40, 30)), _raw(rng, 1, 30)])
    return lanes


def _emit(bw: BitWriter, rng, lane, seg_row) -> int:
    """Write one lane after a random gap of 0-19 bits: each segment's skip
    (random bits), then its codes; fills seg_row and returns the lane's
    start bit."""
    _garbage(bw, rng, int(rng.integers(0, 20)))
    start = bw.bit_length
    for si, (kind, param, codes, *fixed) in enumerate(lane):
        skip = fixed[0] if fixed else int(rng.integers(0, 200))
        _garbage(bw, rng, skip)
        for c in codes:
            if kind == 0:
                q, lsb = c
                bw.write_unary(q)
                bw.write(lsb, param)
            else:
                bw.write(c, param)
        seg_row[si] = _pack(skip, len(codes), param, kind)
    return start


def synthetic_lanes(seed: int = 0, *, wide: bool = False,
                    lanes: int | None = None):
    """A bitstream and its lane tables.  Returns (words2d [R, 16] int32
    holding big-endian uint32 words with a zero guard row, lane_start [L]
    int32, segs [L, SEG] int32); the scan runs with T, NROW and SEG of this
    module.  `lanes` pads the designed cases with random ones (Rice and
    raw mixes) up to that many lanes."""
    rng = np.random.default_rng(seed)
    cases = _lanes(rng, wide)
    while lanes is not None and len(cases) < lanes:
        cases.append([_rice(rng, int(rng.integers(0, 15)),
                            rng.integers(0, 6, 40)),
                      _raw(rng, int(rng.integers(0, 33 if not wide else 40)),
                           40)])
    if lanes is not None:
        cases = cases[:lanes]
    bw = BitWriter()
    lane_start = np.zeros(len(cases), np.int32)
    segs = np.full((len(cases), SEG), SEG_INERT, np.int32)
    for li, lane in enumerate(cases):
        lane_start[li] = _emit(bw, rng, lane, segs[li])
    _garbage(bw, rng, 30)
    bw.pad_to_byte()
    data = bw.getvalue()
    data += bytes((-len(data)) % 64)
    words = np.frombuffer(data, ">u4").astype(np.uint32).reshape(-1, 16)
    words2d = np.pad(words, ((0, 1), (0, 0))).view(np.int32)
    return words2d, lane_start, segs


def _mixed_lane(rng, wide: bool, n: int):
    """Up to six segments of random Rice and raw codes, about n codes:
    lengths from 1 bit to 40 (wide: 70), so codes straddle every refill
    position of a 64-bit reservoir."""
    lane = []
    for _ in range(int(rng.integers(1, 7))):
        c = int(rng.integers(1, max(2, n // 3)))
        if rng.random() < 0.5:
            lane.append(_rice(rng, int(rng.integers(0, 31)),
                              rng.integers(0, 10, c)))
        else:
            lane.append(_raw(rng, int(rng.integers(0, 64 if wide else 33)),
                             c))
    return lane


def _run_lane(rng):
    """Unary runs of 31, 32, 63, 64 and their neighbours (up to 127, the
    longest without overflow) behind random prefixes, so that they start at
    every bit offset of the reservoir."""
    qs = rng.choice([0, 1, 30, 31, 32, 33, 62, 63, 64, 65, 95, 96, 127], 40)
    return [(*_rice(rng, int(rng.integers(0, 5)), qs),
             int(rng.integers(0, 64)))]


def _far_skip_lane(rng, skip: int, kind: int):
    """A segment skip of `skip` bits inside a 65,536-bit window, then codes
    (Rice codes past the window would overflow, so a skip that leaves too
    little room reads raw zeros)."""
    codes = (_rice(rng, 3, rng.integers(0, 6, 60)) if kind == 0
             else _raw(rng, 12, 60))
    return [(*_rice(rng, 2, rng.integers(0, 4, 10)), 0), (*codes, skip)]


def staging_lanes(seed: int = 0, *, wide: bool = False):
    """A bitstream and lane tables for K2's staged CTAs.  Returns (words2d
    [R, 16] int32 holding big-endian uint32 words, lane_start [L] int32,
    segs [L, SEG] int32), scanned with T and SEG of this module and NROW =
    STAGING_NROW.  L = 3 * CTA_LANES + 37:

    - CTA 0, stream order: runs of 31-127 zeros at every alignment, mixed
      Rice and raw lanes, a lane whose run reaches 128 (ovf);
    - CTA 1, reverse stream order: mixed lanes and skips of 60,000 and
      64,000 bits (Rice) and 65,535 bits (raw, past the window) inside its
      staged span;
    - CTA 2, spread: a 400,000-bit gap between its halves makes its span
      larger than a CTA may stage, so it reads global memory;
    - CTA 3, partial (37 lanes) at the end of the stream: its windows run
      past the last row, which holds random bits (no zero guard row), so
      the clamped rows are visible; its last lane decodes past the end.
    """
    rng = np.random.default_rng(seed)
    ovf_lane = [_rice(rng, 2, [5, 128, 3])]
    cta0 = [_run_lane(rng) if i % 2 else _mixed_lane(rng, wide, 60)
            for i in range(CTA_LANES - 1)] + [ovf_lane]
    cta1 = [_mixed_lane(rng, wide, 30) for _ in range(CTA_LANES - 3)] + [
        _far_skip_lane(rng, 60000, 0), _far_skip_lane(rng, 64000, 0),
        _far_skip_lane(rng, 65535, 1)]
    cta2 = [_run_lane(rng) if i % 3 == 0 else _mixed_lane(rng, wide, 40)
            for i in range(CTA_LANES - 1)] + [_far_skip_lane(rng, 61000, 0)]
    cta3 = [_mixed_lane(rng, wide, 40) for _ in range(36)] + [
        [_rice(rng, 4, rng.integers(0, 8, 10)), (0, 4, [])]]
    # the last lane: 10 codes, then a Rice segment of count 0 whose codes
    # the scan takes from segment 0 on, reading the clamped rows
    L = 3 * CTA_LANES + len(cta3)
    lane_start = np.zeros(L, np.int32)
    segs = np.full((L, SEG), SEG_INERT, np.int32)
    bw = BitWriter()
    for li, lane in enumerate(cta0):
        lane_start[li] = _emit(bw, rng, lane, segs[li])
    for i, lane in enumerate(cta1):                  # reverse order
        li = 2 * CTA_LANES - 1 - i
        lane_start[li] = _emit(bw, rng, lane, segs[li])
    for i, lane in enumerate(cta2):
        if i == CTA_LANES // 2:
            _garbage(bw, rng, 400_000)
        li = 2 * CTA_LANES + i
        lane_start[li] = _emit(bw, rng, lane, segs[li])
    for i, lane in enumerate(cta3):
        li = 3 * CTA_LANES + i
        lane_start[li] = _emit(bw, rng, lane, segs[li])
    _garbage(bw, rng, 600)
    _garbage(bw, rng, (-bw.bit_length) % 512)        # random to the row end
    data = bw.getvalue()
    words = np.frombuffer(data, ">u4").astype(np.uint32).reshape(-1, 16)
    return words.view(np.int32), lane_start, segs
