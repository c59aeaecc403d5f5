"""Field lists for holding the bit-pack deposit (kernel K1) against its
plain version, and the plain version against the reference.

`cluster_cases` targets K1's Hopper design, a thread block cluster of
pack_cuda.CLUSTER CTAs a frame, each owning pack_cuda.rank_words words of
a pass over the frame's used words: fields that straddle two ranks'
words, a frame whose words all fall in rank 0's, a negative position that
wraps into the last rank's, fewer fields than CTAs, a row width that is
no multiple of the 16-byte store, and rows wider than the cluster's tiles
(one with every word in play) whose shares hold more than one scan
chunk.  Every case keeps its fields' bits disjoint, so the
kernel's OR and the plain version's add agree.
"""

from __future__ import annotations

import numpy as np

from . import pack_cuda


def cluster_cases():
    """[(label, nzeros [B, S] int32, payload [B, S] int64, pbits [B, S]
    int32, W)] for the cases above."""
    rng = np.random.default_rng(2)
    out = []

    def payload(pb):
        return rng.integers(0, 1 << 63, pb.shape, dtype=np.int64) & (
            (np.int64(1) << pb.astype(np.int64)) - 1)

    def edge(nz, pb, W):
        """The first bit of rank 1's words in a frame's first pass."""
        return 32 * pack_cuda.rank_words(W, pack_cuda.used_words(nz, pb, W))

    W = 64
    nz = np.zeros((3, 42), np.int32)
    pb = np.full((3, 42), 48, np.int32)
    nz[1] = rng.integers(0, 4, 42)
    pb[1] = rng.integers(40, 64, 42)             # runs past W too
    pb[2, 0], pb[2, 1:] = 63, 10
    # a 63-bit field over three words, across the ranks' edge
    nz[2, 0] = next(x for x in range(2000)
                    if x < edge(np.r_[x, nz[2, 1:]], pb[2], W) - 31 < x + 31)
    for f in range(3):
        e = edge(nz[f], pb[f], W)
        ends = np.cumsum(nz[f] + pb[f])
        assert ((ends - pb[f] < e) & (ends > e)).any()   # a field straddles
    out.append(("rank-straddle", nz, payload(pb), pb, W))
    # a negative nzeros (after a field of zeros only) keeps all W words
    # split over the ranks, so ~200 used words fall in rank 0's
    nz = rng.integers(0, 4, (2, 200)).astype(np.int32)
    pb = rng.integers(20, 41, (2, 200)).astype(np.int32)
    nz[:, 9], pb[:, 9], nz[:, 10] = 2, 0, -1
    out.append(("rank-0-only", nz, payload(pb), pb, 8192))
    nz = rng.integers(0, 4, (2, 300)).astype(np.int32)
    nz[:, 0] = -100                              # words 8188.. after wrap
    pb = rng.integers(10, 31, (2, 300)).astype(np.int32)
    out.append(("wrap-to-last-rank", nz, payload(pb), pb, 8192))
    pb = rng.integers(1, 64, (4, 1)).astype(np.int32)
    out.append(("S-below-cluster", rng.integers(0, 6, (4, 1)).astype(
        np.int32), payload(pb), pb, 16))
    pb = np.full((3, 30), 40, np.int32)          # 1200 bits into 37 words
    out.append(("odd-W", np.zeros((3, 30), np.int32), payload(pb), pb, 37))
    # ~39k used words: two passes; the second frame keeps all W words
    nz = np.zeros((2, 30000), np.int32)
    pb = rng.integers(20, 64, (2, 30000)).astype(np.int32)
    nz[1, 9], pb[1, 9], nz[1, 10] = 2, 0, -1
    out.append(("multi-pass", nz, payload(pb), pb, 40960))
    return out
