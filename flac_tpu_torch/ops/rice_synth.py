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
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitWriter
from .bitunpack import SEG_INERT

T = 128          # codes per lane, as the decoder's tiles
NROW = 8         # window rows: 4096 bits
SEG = 8          # segment slots per lane
_BUDGET = 3000   # bits a well-formed lane may use inside its window


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
        _garbage(bw, rng, int(rng.integers(0, 20)))
        lane_start[li] = bw.bit_length
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
            segs[li, si] = _pack(skip, len(codes), param, kind)
    _garbage(bw, rng, 30)
    bw.pad_to_byte()
    data = bw.getvalue()
    data += bytes((-len(data)) % 64)
    words = np.frombuffer(data, ">u4").astype(np.uint32).reshape(-1, 16)
    words2d = np.pad(words, ((0, 1), (0, 0))).view(np.int32)
    return words2d, lane_start, segs
