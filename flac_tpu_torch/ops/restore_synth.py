"""Synthetic batches for kernel K3 (the restore, csrc/restore.cu), made from
a seed with numpy.  Each pins a corner of `bitunpack.restore_undo_body`'s
contract that the decoders' real batches rarely reach: every order bucket
of the kernel, int32 wrap-around, wide int64 samples, int16 and int64
residuals, strided rows, tails that are not a multiple of the kernel's load
group, the int16 narrowing, the bps-range flags, 1, 2 and 6 channels with
every stereo assignment, frames that straddle a warp, and the shift and
wasted-bit edges.  The CPU tests hold the plain version against flac_tpu on
them; chip_smoke.py and the card-only tests hold the kernel against the
plain version.
"""

from __future__ import annotations

import numpy as np

from .. import format as fmt

ASSIGNMENTS = (fmt.CHANNEL_ASSIGNMENT_INDEPENDENT,
               fmt.CHANNEL_ASSIGNMENT_LEFT_SIDE,
               fmt.CHANNEL_ASSIGNMENT_RIGHT_SIDE,
               fmt.CHANNEL_ASSIGNMENT_MID_SIDE)


def batch(seed: int, *, B: int, C: int, N: int, max_order: int,
          taps: str = "stable", res_bits: int = 10, res_dtype=np.int32,
          extra_cols: int = 0, wasted_max: int = 0, orders=None,
          shifts=None) -> dict:
    """One batch of restore inputs.

    taps: "stable" gives order-1/2 integrators (the signal stays near its
    residuals' range, so the bps-range flags differ frame by frame),
    "random" random 15-bit taps (the recursion grows until it wraps).
    extra_cols > 0 makes res a strided view: rows of N + extra_cols.
    """
    rng = np.random.default_rng(seed)
    S = B * C
    lim = 1 << (res_bits - 1)
    res = rng.integers(-lim, lim, (S, N + extra_cols), dtype=np.int64)
    if orders is None:
        orders = rng.integers(0, max_order + 1, S)
    order = np.asarray(orders, np.int32)
    qlp = np.zeros((S, max_order), np.int32)
    if shifts is None:
        shifts = rng.integers(0, 16, S)
    shift = np.asarray(shifts, np.int32)
    if taps == "random":
        for s in range(S):
            qlp[s, :order[s]] = rng.integers(-(1 << 14), 1 << 14, order[s])
    elif max_order:
        # x[n] = x[n-1] + r (fixed order 1) or 2x[n-1] - x[n-2] (order 2),
        # shift 0: the fixed predictors as the native parse normalizes them
        for s in range(S):
            k = min(int(order[s]), 2, max_order)
            qlp[s, :k] = (1,) if k == 1 else (2, -1)[:k]
            shift[s] = 0
            order[s] = k
        res = res >> 4
    wasted = rng.integers(0, wasted_max + 1, S).astype(np.int32)
    assignment = rng.choice(ASSIGNMENTS, B).astype(np.int32)
    return dict(res=res.astype(res_dtype), order=order, shift=shift,
                qlp=qlp, wasted=wasted, assignment=assignment)


def cases() -> list:
    """(label, arrays, static arguments of restore_undo_body) for each
    corner.  res may have more columns than blocksize (a strided view)."""
    out = []

    def add(label, arrays, **kw):
        kw.setdefault("wide", False)
        kw.setdefault("out16", False)
        kw.setdefault("bps", 0)
        out.append((label, arrays, kw))

    for mo in (0, 1, 8, 12, 32):
        # max_order 0: no taps, the kernel's order-1 template on a zero tap
        add(f"order bucket {mo}, random taps, stereo",
            batch(100 + mo, B=8, C=2, N=200, max_order=mo, taps="random"),
            blocksize=200, channels=2, max_order=mo)
    add("narrow int32 wrap (random 15-bit taps, 24-bit residuals)",
        batch(1, B=5, C=2, N=96, max_order=32, taps="random", res_bits=24),
        blocksize=96, channels=2, max_order=32)
    wide = batch(2, B=6, C=2, N=120, max_order=12, taps="random",
                 res_bits=40, res_dtype=np.int64, wasted_max=3)
    add("wide int64 samples, int64 residuals", wide, blocksize=120,
        channels=2, max_order=12, wide=True, bps=32)
    add("wide, int16 residuals",
        batch(3, B=4, C=2, N=64, max_order=8, taps="random",
              res_dtype=np.int16), blocksize=64, channels=2, max_order=8,
        wide=True)
    add("narrow, int64 residuals truncated to int32",
        batch(4, B=4, C=2, N=64, max_order=4, taps="random", res_bits=40,
              res_dtype=np.int64), blocksize=64, channels=2, max_order=4)
    add("out16 with bps-range flags (16-bit)",
        batch(5, B=24, C=2, N=256, max_order=2, res_bits=13, wasted_max=2),
        blocksize=256, channels=2, max_order=2, out16=True, bps=16)
    add("int16 residuals, out16, strided rows, tail of 5 (scalar path)",
        batch(6, B=9, C=2, N=205, max_order=8, res_bits=12,
              res_dtype=np.int16, extra_cols=11),
        blocksize=205, channels=2, max_order=8, out16=True, bps=16)
    add("bps-range flags at 8 and 24 bits: 8-bit",
        batch(7, B=16, C=1, N=64, max_order=1, res_bits=9),
        blocksize=64, channels=1, max_order=1, bps=8)
    add("bps-range flags at 8 and 24 bits: 24-bit",
        batch(8, B=16, C=2, N=64, max_order=2, res_bits=26, wasted_max=1),
        blocksize=64, channels=2, max_order=2, bps=24)
    add("mono, 37 subframes (a partial warp)",
        batch(9, B=37, C=1, N=72, max_order=16, taps="random"),
        blocksize=72, channels=1, max_order=16, bps=16)
    six = batch(10, B=7, C=6, N=48, max_order=8, taps="random")
    add("6 channels, frames straddling warps", six, blocksize=48,
        channels=6, max_order=8, bps=16)
    # every assignment on every frame pattern: 4 assignments x 3 frames
    every = batch(11, B=12, C=2, N=40, max_order=2, res_bits=16)
    every["assignment"] = np.repeat(np.asarray(ASSIGNMENTS, np.int32), 3)
    add("stereo, every assignment", every, blocksize=40, channels=2,
        max_order=2, bps=16)
    edges = batch(12, B=6, C=2, N=32, max_order=4, taps="random",
                  res_bits=16, shifts=[0, 15, 7, 0, 15, 1] * 2,
                  orders=[4, 0, 1, 3, 4, 2] * 2)
    edges["wasted"] = np.asarray([0, 1, 5, 15, 31, 32] * 2, np.int32)
    add("shift 0/15 and wasted 0..32", edges, blocksize=32, channels=2,
        max_order=4)
    edges_wide = {k: v.copy() for k, v in edges.items()}
    edges_wide["res"] = edges["res"].astype(np.int64)
    edges_wide["wasted"] = np.asarray([0, 31, 32, 33, 63, 64] * 2, np.int32)
    add("wide, wasted 0..64", edges_wide, blocksize=32, channels=2,
        max_order=4, wide=True)
    add("max_order 5 (not a bucket: zero taps padded to 8)",
        batch(13, B=3, C=2, N=24, max_order=5, taps="random"),
        blocksize=24, channels=2, max_order=5)
    return out
