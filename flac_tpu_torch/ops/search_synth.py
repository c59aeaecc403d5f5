"""Synthetic inputs for the search's kernels, made from a seed with numpy:
K6 (the LPC coefficient stage, csrc/lpc_coeffs.cu), K7 (the Rice cost
table, csrc/rice_cost.cu), K8 (the candidate residuals,
csrc/candidate_residuals.cu) and K9 (the select and realize,
csrc/select_realize.cu).

Each case pins a corner of the plain versions (models/subframe.py
lpc_candidates_plain, _rice_cost_plain, candidate_residuals_plain and
select_and_realize_plain) that the encoder's real batches rarely reach.

K6 (`lpc_cases`): autocorrelations of windowed signals beside
silence (autoc[0] == 0), exact fits that kill the later orders (a
constant signal's autocorrelation: the error reaches 0 at order 1), a
non-positive-definite autocorrelation whose error goes negative (the
estimate's 1e32) at order 1 or only from order 2, constant blocks under a
window, white-noise rows whose orders all score exactly the same bits (the
guess must take the first), -e, -p and -e -p, the precision branch past
17 bits (up to the 33-bit side), orders 1 to 32 (6, 8 and 12, the
kernel's templates, and its generic path with every lane busy: order 32
at N = 33 under -e -p), and N of 16, 33, 1152, 4096 and 4608.

K7 (`rice_cases`): residual rows of Laplacian-like partitions of
scattered sizes, with every partition order up to the largest each
blocksize allows (16, 1152, 4096, 4608, and 4096 and 32768 at -r 15:
4096 and 32768 partitions of one sample), escape coding with raw widths 0
(silent partitions) and 31 and 32, RICE2 parameters past 14 (24-bit and
32-bit configurations), residuals of +-(2^31 - 1) and -2^31 (a RICE2 row
of -2^31 only at N=32768: every bit count at its largest, S_0 near
2^47), predictor orders
up to 32 (partition 0 past its samples: invalid levels), and a minimum
partition order above 0.

K8 (`residual_cases`): signals of 16, 17, 24 and 28 bits (int32) and the
33-bit side (int64, rows past 2^31), each candidate's coefficients either
a polynomial predictor scaled by its shift (small residuals: valid rows)
or random within its precision (5-15 bits), shifts 0 and 15 among them,
zero past each order as the quantizer writes them; orders 1-32 (all of
them on one row), up to 32 at N=33 and 15 at N=16, orders past N - 1 at
N=4 (the fixed orders past N too); "i32" rows whose range analysis fails
(coefficients near 2^14 at order 32 on 17-bit signals: the sums wrap);
"f64" rows at 24 bits, wide fixed rows at 28 bits and on the 33-bit side
with rows over 2^31 (flags false); AC = 0 (no LPC), -e -p's 132
candidates a channel; N of 4, 16, 33, 513, 1000, 1152, 4096, 4097, 4608
and 32768 (K8's spans of 512 samples: not whole, one sample past one,
one past eight); 24-bit "f64" rows at their extreme (order 32, |q| near
2^14, the side at +-(2^24 - 1), sums near 2^44) and at AC = 9 (-8); a
24-bit "f64" row and a 28-bit wide fixed row whose only residual past
2^31 lies in the row's last span (the flag K8 ORs over a row's CTAs).

K9 (`select_cases`): Rice cost tables with BIG levels and exact ties
between partition orders, candidates whose totals tie exactly (two LPC
candidates alike, a fixed order and an LPC candidate, a candidate and
verbatim), constant blocks, rows whose every candidate is BIG or invalid
(verbatim wins), N < 5 (fixed orders past N), AC = 0 and -e -p, RICE2
flags and parameters past 14, wasted bits, the 33-bit side (int64
signals and warm-up), N of 4, 16, 33, 1152, 4096 and 32768.

chip_smoke.py and the card-only tests hold K6-K9 against their plain
versions on them; the CPU tests hold the plain versions against
flac_tpu's on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..config import EncoderConfig

BIG = 1 << 28            # ops/rice.py BIG


def _config(N: int, bps: int = 16, **kw) -> EncoderConfig:
    return EncoderConfig.from_preset(5, blocksize=N, bits_per_sample=bps,
                                     **kw).resolve()


def _autocorrelation(x: np.ndarray, O: int) -> np.ndarray:
    """[..., N] float64 -> [..., O+1] sums of x[n] * x[n+l]."""
    N = x.shape[-1]
    return np.stack([(x[..., :N - lag] * x[..., lag:]).sum(-1)
                     for lag in range(O + 1)], axis=-1)


def lpc_batch(seed: int, *, B: int, CH: int, A: int, O: int, N: int,
              bps: int = 16, corners: bool = True, ties: int = 0) -> dict:
    """Autocorrelations [B, CH, A, O+1] of windowed signals (a tone and
    filtered noise) of N samples (each apodization a Tukey window of its
    own width) and bps_eff [B, CH] near `bps`; with `corners`, rows 0-3 of
    the first frame are silence, an exact fit, a negative error and a
    constant block.  With `ties` (the configuration's qlp precision, N a
    power of two), rows 4 and up are white noise whose every order's
    error is autoc[0] = 2^(2 ovh + 1) N (ovh = bps_eff + ties): every
    order's estimated bits are exactly ovh N, a tie the guess breaks to
    order 1; and row 5 has a positive error at order 1 and a negative one
    from order 2."""
    rng = np.random.default_rng(seed)
    n = np.arange(N)
    sig = np.zeros((B, CH, N))
    for b in range(B):
        for c in range(CH):
            # a tone and noise through a random FIR of 2..8 taps
            taps = rng.uniform(-1, 1, int(rng.integers(2, 9)))
            e = rng.standard_normal(N + len(taps)) * 10 ** rng.uniform(0, 3)
            tone = 3000 * np.sin(2 * np.pi * rng.uniform(0.001, 0.1) * n)
            sig[b, c] = tone + np.convolve(e, taps, "valid")[:N]
    sig = np.round(sig * 2.0 ** (bps - 16))
    autoc = np.empty((B, CH, A, O + 1))
    for a_ in range(A):
        width = 0.1 + 0.8 * a_ / max(A - 1, 1)
        w = np.ones(N)
        t = int(width * N / 2)
        if t > 0:
            ramp = 0.5 * (1 - np.cos(np.pi * np.arange(t) / t))
            w[:t], w[N - t:] = ramp, ramp[::-1]
        xw = (sig * w).astype(np.float32).astype(np.float64)
        autoc[:, :, a_] = _autocorrelation(xw, O)
    bps_eff = (bps + rng.integers(0, 2, (B, CH))).astype(np.int32)
    if corners and B * CH >= 4:
        flat = autoc.reshape(B * CH, A, O + 1)
        flat[0] = 0.0                                  # silence
        flat[1] = 5.0e9                                # exact fit, order 1
        flat[2, :, 0], flat[2, :, 1:] = 1.0e6, 1.9e6   # error < 0
        const = np.full(N, 1000.0 * 2 ** (bps - 16))
        w = np.hanning(N) if N > 1 else np.ones(N)
        flat[3] = _autocorrelation((const * w).astype(np.float32)
                                   .astype(np.float64), O)
    if ties and B * CH >= 6:
        flat = autoc.reshape(B * CH, A, O + 1)
        ovh = bps_eff.reshape(-1).astype(np.int64) + ties
        flat[4:] = 0.0
        flat[4:, :, 0] = np.ldexp(float(N), 2 * ovh[4:] + 1)[:, None]
        flat[5, :, 0], flat[5, :, 1], flat[5, :, 2:] = 1.0e6, 0.0, 1.9e6
    return {"autoc": autoc, "bps_eff": bps_eff}


def lpc_cases() -> list:
    """[(label, case)]: a case is lpc_batch's arrays with "N" and "cfg"."""
    out = []

    def add(label, N, cfg, **kw):
        O = min(cfg.max_lpc_order, N - 1)
        case = lpc_batch(len(out) + 1, N=N, O=O, **kw)
        case.update(N=N, cfg=cfg)
        out.append((label, case))

    add("-5, order 8, N=4096", 4096, _config(4096), B=4, CH=4, A=1)
    add("-8, order 12, 3 apodizations, N=4608", 4608,
        _config(4608, max_lpc_order=12), B=3, CH=4, A=3)
    add("-e, order 12, N=1152", 1152,
        _config(1152, max_lpc_order=12, do_exhaustive_model_search=True),
        B=2, CH=4, A=2)
    add("-p, order 8, N=4096", 4096,
        _config(4096, do_qlp_coeff_prec_search=True), B=2, CH=4, A=2)
    add("-e -p, order 6, N=1152", 1152,
        _config(1152, max_lpc_order=6, do_exhaustive_model_search=True,
                do_qlp_coeff_prec_search=True), B=2, CH=2, A=2)
    add("order 32, N=4096", 4096, _config(4096, max_lpc_order=32),
        B=2, CH=4, A=2)
    add("order 1, N=4096", 4096, _config(4096, max_lpc_order=1),
        B=2, CH=2, A=1)
    add("N=16: order 8, short block", 16, _config(16), B=4, CH=2, A=2)
    add("N=16, order 32 cut to 15", 16, _config(16, max_lpc_order=32),
        B=2, CH=2, A=1)
    add("bps 24: the precision above 17 bits", 4096,
        _config(4096, 24, max_lpc_order=12), B=2, CH=4, A=2, bps=24)
    add("bps 32, -p: the 33-bit side's precisions", 1152,
        _config(1152, 32, do_qlp_coeff_prec_search=True), B=2, CH=4, A=1,
        bps=32)
    add("bps 17, orders 1-32 under -e", 4096,
        _config(4096, max_lpc_order=32, do_exhaustive_model_search=True),
        B=1, CH=4, A=1, bps=17)
    add("-3: order 6, N=4096", 4096, _config(4096, max_lpc_order=6),
        B=4, CH=2, A=1)
    add("ties: every order's bits equal; a negative error from order 2",
        4096, _config(4096), B=2, CH=4, A=2, ties=12)
    add("near-ties at order 12: N=4608, the bits differ in their last places", 4608,
        _config(4608, max_lpc_order=12), B=2, CH=4, A=1, ties=12)
    add("-e -p, order 32, N=33: the generic path, every lane busy", 33,
        _config(33, max_lpc_order=32, do_exhaustive_model_search=True,
                do_qlp_coeff_prec_search=True), B=2, CH=2, A=2)
    return out


def rice_batch(seed: int, *, B: int, CH: int, C: int, N: int,
               max_po: int, bits: int = 14, edges: bool = False,
               max_order: int = 12, lowest: bool = False) -> dict:
    """Residual rows [B, CH, C, N] int32, zero below each row's order
    [B, CH, C] (0..max_order, row 0 of each frame order 0): partitions of
    2^max_po with magnitudes of 0..`bits` bits each (some silent); with
    `edges`, some rows full-scale (+-(2^31 - 1), -2^31) and some
    partitions near 2^30; with `lowest`, the order-0 rows all -2^31 (every
    zigzagged bit set)."""
    rng = np.random.default_rng(seed)
    P = 1 << max_po
    m = N // P
    rows = B * CH * C
    scale_bits = rng.integers(0, bits + 1, (rows, P))
    silent = rng.random((rows, P)) < 0.15
    mag = np.floor(rng.exponential(1.0, (rows, P, m))
                   * (2.0 ** scale_bits[..., None]))
    mag = np.where(silent[..., None], 0, np.minimum(mag, 2.0 ** 31 - 1))
    r = (mag * rng.choice([-1, 1], mag.shape)).reshape(rows, N)
    if edges:
        r[0::7] = rng.choice([-(2 ** 31), 2 ** 31 - 1, -(2 ** 31 - 1)],
                             (len(r[0::7]), N))
        big = rng.random((rows, P)) < 0.1
        r = np.where(np.repeat(big, m, axis=1),
                     rng.integers(-(2 ** 30), 2 ** 30, (rows, N)), r)
    order = rng.integers(0, max_order + 1, rows).astype(np.int32)
    order[::C] = 0
    if lowest:
        r[::C] = -(2 ** 31)
    r[np.arange(N)[None, :] < order[:, None]] = 0
    return {"res": r.astype(np.int32).reshape(B, CH, C, N),
            "order": order.reshape(B, CH, C)}


def rice_cases() -> list:
    """[(label, case)]: a case is rice_batch's arrays with "N", "max_po"
    and "cfg"; max_po is the search's, from the configuration and N."""
    out = []

    def add(label, N, cfg, **kw):
        max_po = fmt.max_rice_partition_order_limited(
            cfg.max_residual_partition_order, N, 0)
        case = rice_batch(len(out) + 1, N=N, max_po=max_po, **kw)
        case.update(N=N, max_po=max_po, cfg=cfg)
        out.append((label, case))

    add("-5, N=4096, P=32", 4096, _config(4096), B=2, CH=4, C=6)
    add("-8, N=4096, P=64", 4096, _config(4096,
                                          max_residual_partition_order=6),
        B=2, CH=2, C=8)
    add("-r 15, N=4096: 4096 partitions of one sample", 4096,
        _config(4096, max_residual_partition_order=15), B=1, CH=2, C=3)
    add("N=4608: 512 partitions of 9 samples", 4608,
        _config(4608, max_residual_partition_order=15), B=1, CH=2, C=3)
    add("N=1152: 128 partitions of 9", 1152,
        _config(1152, max_residual_partition_order=15), B=2, CH=2, C=3)
    add("N=16, every order to 16 partitions of one sample", 16,
        _config(16, max_residual_partition_order=15), B=3, CH=2, C=6,
        max_order=15)
    add("N=4096, one partition (-r 0)", 4096,
        _config(4096, max_residual_partition_order=0), B=2, CH=2, C=3)
    add("escapes: raw widths 0, 31, 32; full-scale rows", 4096,
        _config(4096, do_escape_coding=True), B=2, CH=2, C=7, bits=24,
        edges=True)
    add("RICE2 (24-bit): parameters past 14, full-scale rows", 4096,
        _config(4096, 24, max_residual_partition_order=8), B=2, CH=2, C=7,
        bits=26, edges=True)
    add("RICE2 with escapes (32-bit), N=1152", 1152,
        _config(1152, 32, do_escape_coding=True,
                max_residual_partition_order=15), B=2, CH=2, C=6, bits=31,
        edges=True)
    add("orders up to 32 past short partitions, min_po 2", 256,
        _config(256, max_residual_partition_order=6,
                min_residual_partition_order=2), B=2, CH=2, C=8,
        max_order=32)
    add("-r 15, N=32768: 32768 partitions of one sample, 16 levels", 32768,
        _config(32768, max_residual_partition_order=15), B=1, CH=1, C=2)
    add("RICE2, N=32768: a row of -2^31 only, S_0 near 2^47", 32768,
        _config(32768, 24), B=1, CH=1, C=2, bits=20, lowest=True)
    return out


def as_lpc_inputs(case: dict, device):
    """(autoc, bps_eff, N, cfg) on `device`."""
    return (torch.from_numpy(case["autoc"]).to(device),
            torch.from_numpy(case["bps_eff"]).to(device), case["N"],
            case["cfg"])


def as_rice_inputs(case: dict, device):
    """(res, order, N, max_po, cfg) on `device`."""
    return (torch.from_numpy(case["res"]).to(device),
            torch.from_numpy(case["order"]).to(device), case["N"],
            case["max_po"], case["cfg"])


# ---------------------------------------------------------------------------
# K8: the candidate residuals
# ---------------------------------------------------------------------------

# a polynomial predictor of degree k - 1 (the fixed orders' taps, sign
# flipped): x[n] ~ sum_j P[k][j] x[n-1-j]
_POLY = {1: (1,), 2: (2, -1), 3: (3, -3, 1), 4: (4, -6, 4, -1)}


def residual_batch(seed: int, *, B: int, CH: int, N: int, AC: int,
                   bps: int, max_order: int, x64: bool = False,
                   order_lo: int = 1, all_orders: bool = False,
                   wrap: bool = False) -> dict:
    """x [B, CH, N] (int64 with `x64`) of `bps` bits: a slow tone and
    filtered noise, some rows at full scale; qc [B, CH, AC, 32] int32,
    qshift and cand_order [B, CH, AC] int32 (orders order_lo..max_order,
    or with `all_orders` 1..AC on every row), bps_eff [B, CH] int32.
    Half the candidates are a polynomial predictor << shift (0..12), the
    rest random within a precision of 5-15 bits (shifts 0..15, 0 and 15
    among them); with `wrap`, every other candidate is order 32 with
    coefficients near 2^14 (the "i32" range analysis fails and the sums
    wrap)."""
    rng = np.random.default_rng(seed)
    amp = float(2 ** (bps - 1) - 1)
    n = np.arange(N)
    x = np.empty((B, CH, N))
    for b in range(B):
        for c in range(CH):
            f = rng.uniform(0.0005, 0.02)
            e = rng.standard_normal(N + 4) * amp * 10 ** rng.uniform(-4, -1)
            tone = np.sin(2 * np.pi * f * n + rng.uniform(0, 6))
            x[b, c] = tone * amp * rng.uniform(0.05, 1.0) \
                + np.convolve(e, rng.uniform(-1, 1, 5), "valid")[:N]
    x = np.clip(np.round(x), -amp, amp)
    x.reshape(-1, N)[::3] = np.where(rng.random(N) < 0.5, amp, -amp)
    top = max(1, min(fmt.MAX_LPC_ORDER, N - 1, max_order))
    if all_orders:
        order = np.broadcast_to(np.minimum(np.arange(1, AC + 1), top),
                                (B, CH, AC)).copy()
    else:
        order = rng.integers(min(order_lo, top), top + 1, (B, CH, AC))
    qc = np.zeros((B, CH, AC, fmt.MAX_LPC_ORDER), np.int64)
    shift = rng.integers(0, 16, (B, CH, AC))
    shift.reshape(-1)[0::4] = 0
    shift.reshape(-1)[1::4] = 15
    poly = rng.random((B, CH, AC)) < 0.5
    for idx in np.ndindex(B, CH, AC):
        o = int(order[idx])
        if wrap and idx[2] % 2 == 1:
            order[idx] = o = top
            qc[idx][:o] = rng.choice([-1, 1], o) * rng.integers(
                2 ** 13, 2 ** 14, o)
        elif poly[idx]:
            shift[idx] = min(int(shift[idx]), 12)
            taps = _POLY[min(o, 4)]
            qc[idx][:len(taps)] = np.array(taps) << int(shift[idx])
        else:
            p = int(rng.integers(5, 16))
            qc[idx][:o] = rng.integers(-(2 ** (p - 1)), 2 ** (p - 1), o)
    bps_eff = np.full((B, CH), bps, np.int32)
    return {"x": x.astype(np.int64 if x64 else np.int32),
            "qc": qc.astype(np.int32), "qshift": shift.astype(np.int32),
            "cand_order": order.astype(np.int32), "bps_eff": bps_eff}


def extreme_batch(seed: int, *, N: int, bps: int, AC: int) -> dict:
    """[1, 2, N] int32 side signals of a `bps`-bit source at their
    extreme (+-(2^bps - 1): a run of each sign, then random signs) and AC
    candidates of order 32 whose coefficients share one sign and lie near
    2^14 (2^14 .. 2^15 - 1), shifts 0, 15 and between: the "f64" sums
    reach ~2^44, and the residuals both pass 2^31 (flags false) and stay
    within it."""
    rng = np.random.default_rng(seed)
    amp = 2 ** bps - 1
    x = np.empty((1, 2, N), np.int64)
    x[..., :N // 3] = amp
    x[..., N // 3:2 * N // 3] = -amp
    x[..., 2 * N // 3:] = rng.choice([-amp, amp], (1, 2, N - 2 * N // 3))
    sign = np.where(np.arange(AC) % 2 == 0, 1, -1)[None, None, :, None]
    qc = sign * rng.integers(2 ** 14, 2 ** 15, (1, 2, AC, fmt.MAX_LPC_ORDER))
    shift = rng.integers(0, 16, (1, 2, AC))
    shift[..., 0::3] = 0
    shift[..., 1::3] = 15
    return {"x": x.astype(np.int32), "qc": qc.astype(np.int32),
            "qshift": shift.astype(np.int32),
            "cand_order": np.full((1, 2, AC), fmt.MAX_LPC_ORDER, np.int32),
            "bps_eff": np.full((1, 2), bps + 1, np.int32)}


def spike_batch(seed: int, *, N: int, bps: int, at: int) -> dict:
    """[1, 2, N] int32 side signals of a `bps`-bit source, small
    (|x| < 2^12) but for row 0's samples at..at+4, +-(2^bps - 1)
    alternating: there alone the fourth difference (16 (2^bps - 1), past
    2^31 from 28 bits) and the residual of an order-1 candidate of 2^14
    at shift 0 pass 2^31.  Row 0's other candidate (the second
    difference: order 2, shift 13) and row 1 stay within it.  With `at`
    in a row's last span, the flags that go false come from that span
    only."""
    rng = np.random.default_rng(seed)
    amp = 2 ** bps - 1
    x = rng.integers(-2 ** 12, 2 ** 12, (1, 2, N))
    x[0, 0, at:at + 5] = amp * np.array([1, -1, 1, -1, 1])
    qc = np.zeros((1, 2, 2, fmt.MAX_LPC_ORDER), np.int64)
    qc[..., 0, 0] = 2 ** 14
    qc[..., 1, :2] = (2 ** 14, -2 ** 13)
    return {"x": x.astype(np.int32), "qc": qc.astype(np.int32),
            "qshift": np.array([[[0, 13]] * 2], np.int32),
            "cand_order": np.array([[[1, 2]] * 2], np.int32),
            "bps_eff": np.full((1, 2), bps + 1, np.int32)}


def residual_cases() -> list:
    """[(label, case)]: a case is residual_batch's arrays with "N",
    "fixed_wide", "lpc_mode" and "max_order" (the search's arguments for
    a configuration of its bits)."""
    out = []

    def add(label, N, bps, max_order, make=residual_batch, **kw):
        case = make(len(out) + 1, N=N, bps=bps, **kw) if make is not \
            residual_batch else residual_batch(
                len(out) + 1, N=N, bps=bps, max_order=max_order, **kw)
        side = bps if kw.get("x64") else bps + 1   # the side's extra bit
        case.update(N=N, fixed_wide=side >= 28,
                    lpc_mode="i32" if side <= 17 else "f64",
                    max_order=min(max_order, N - 1))
        out.append((label, case))

    add("-5: order 8, N=4096", 4096, 16, 8, B=2, CH=4, AC=1)
    add("-8: 9 candidates to order 12, N=4608", 4608, 16, 12, B=2, CH=4,
        AC=9)
    add("orders 1-32 on one row, N=4096", 4096, 16, 32, B=1, CH=2, AC=32,
        all_orders=True)
    add("i32 rows whose range analysis fails: order 32, q near 2^14", 1152,
        16, 32, B=2, CH=2, AC=4, wrap=True)
    add("N=16: orders to 15", 16, 16, 15, B=2, CH=4, AC=6)
    add("N=33: orders to 32 (-e -p)", 33, 16, 32, B=2, CH=2, AC=64,
        all_orders=True)
    add("-e -p: 132 candidates a channel, N=1152", 1152, 16, 12, B=1, CH=2,
        AC=132)
    add("N=32768: order 8", 32768, 16, 8, B=1, CH=2, AC=2)
    add("24-bit: f64 rows, order 12, N=4096", 4096, 24, 12, B=2, CH=2,
        AC=3)
    add("28-bit: wide fixed rows from int32, f64, N=4608", 4608, 28, 8,
        B=2, CH=2, AC=2)
    add("33-bit side: int64 rows past 2^31, N=4096", 4096, 33, 8, B=2,
        CH=2, AC=4, x64=True)
    add("AC = 0: the fixed orders only, N=4096", 4096, 16, 0, B=2, CH=4,
        AC=0)
    add("AC = 0 on the 33-bit side, N=1152", 1152, 33, 0, B=1, CH=2, AC=0,
        x64=True)
    add("N=4: orders to 3, fixed orders past N", 4, 16, 32, B=2, CH=2,
        AC=3)
    # K8's spans of 512 samples (csrc/candidate_residuals.cu SPAN): N
    # not a multiple of one, N one sample past one and past eight (a
    # cluster's rank 0 takes the ninth)
    add("N=1000: spans not whole, scalar stores", 1000, 16, 12, B=1,
        CH=2, AC=3)
    add("N=513: one sample past a span", 513, 16, 8, B=1, CH=2, AC=2)
    add("24-bit f64, N=4097: one sample past eight spans", 4097, 24, 8,
        B=1, CH=2, AC=2)
    add("24-bit f64 at the extreme: order 32, q near 2^14, +-(2^24 - 1)",
        1152, 24, 32, make=extreme_batch, AC=3)
    add("24-bit f64: the only residual past 2^31 in the last span",
        4096, 24, 2, make=spike_batch, at=4000)
    add("28-bit wide fixed: the only residual past 2^31 in the last span",
        4096, 28, 2, make=spike_batch, at=3700)
    add("24-bit f64, AC = 9 (-8), N=4096", 4096, 24, 12, B=1, CH=2, AC=9)
    return out


def as_residual_inputs(case: dict, device):
    """(x, qc, qshift, cand_order, bps_eff, fixed_wide, lpc_mode,
    max_order) on `device`: candidate_residuals' arguments."""
    return (*(torch.from_numpy(case[k]).to(device) for k in (
        "x", "qc", "qshift", "cand_order", "bps_eff")),
        case["fixed_wide"], case["lpc_mode"], case["max_order"])


# ---------------------------------------------------------------------------
# K9: the select and realize
# ---------------------------------------------------------------------------

SELECT_KEYS = ("x", "bps_eff", "wasted", "res_all", "order_all", "f_ok",
               "cand_ok", "fit_ok", "prec", "qc", "qshift", "r_bits",
               "r_ks", "r_rice2")


def select_batch(seed: int, *, B: int, CH: int, N: int, AC: int,
                 max_po: int, bps: int = 16, x64: bool = False,
                 rice2: bool = False) -> dict:
    """select_and_realize's arguments for B x CH rows of N samples with
    AC LPC candidates and L = max_po + 1 partition orders (P = 2^max_po
    parameters), arrays keyed by SELECT_KEYS.  The rows, in turn: plain
    costs; a constant block; every candidate BIG or invalid (verbatim
    wins); two LPC candidates alike (their totals tie); a fixed order
    tying an LPC candidate; the best candidate tying verbatim exactly;
    and in every row the cheapest partition order's bits repeated at a
    later order (a tie the argmin breaks to the first) and some levels
    BIG."""
    rng = np.random.default_rng(seed)
    C, L, P = 5 + AC, max_po + 1, 1 << max_po
    R = B * CH
    amp = 2 ** (bps - 1) - 1
    x = rng.integers(-amp, amp + 1, (R, N), dtype=np.int64)
    bps_eff = rng.integers(max(bps - 2, 1), bps + 1, R).astype(np.int32)
    wasted = rng.integers(0, 3, R).astype(np.int32)
    res = rng.integers(-(2 ** 20), 2 ** 20, (R, C, N)).astype(np.int32)
    order_all = np.concatenate(
        [np.broadcast_to(np.arange(5), (R, 5)),
         rng.integers(1, min(32, max(N - 1, 1)) + 1, (R, AC))], axis=1)
    f_ok = rng.random((R, 5)) < 0.9
    cand_ok = rng.random((R, AC)) < 0.8
    fit_ok = rng.random((R, AC)) < 0.9
    prec = rng.integers(5, 16, (R, AC))
    qc = rng.integers(-(2 ** 14), 2 ** 14, (R, AC, 32))
    qshift = rng.integers(0, 16, (R, AC))
    raw = N * bps_eff[:, None, None]
    r_bits = (raw * rng.uniform(0.2, 1.2, (R, C, L))).astype(np.int64)
    r_bits[rng.random((R, C, L)) < 0.15] = BIG
    # the cheapest level again at a later level: the first must win
    best = r_bits.argmin(-1)
    later = np.minimum(best + 1 + rng.integers(0, L, (R, C)), L - 1)
    np.put_along_axis(r_bits, later[..., None],
                      np.take_along_axis(r_bits, best[..., None], -1), -1)
    r_ks = rng.integers(0, 31 if rice2 else 15, (R, C, L, P))
    r_rice2 = (rng.random((R, C, L)) < 0.5) if rice2 else \
        np.zeros((R, C, L), bool)
    ovh = 8 + wasted.astype(np.int64)
    hdr = np.concatenate(
        [ovh[:, None] + np.arange(5)[None] * bps_eff[:, None],
         ovh[:, None] + 9 + order_all[:, 5:] * (prec + bps_eff[:, None])],
        axis=1)
    for i in range(R):
        kind = i % 6
        if kind == 1:                      # a constant block
            x[i] = x[i, 0]
        elif kind == 2:                    # nothing but verbatim
            r_bits[i] = BIG
            f_ok[i] = False
        elif kind == 3 and AC >= 2:        # two LPC candidates alike
            for arr in (order_all, r_bits):
                arr[i, 6] = arr[i, 5]
            for arr in (cand_ok, fit_ok, prec):
                arr[i, 1] = arr[i, 0]
            cand_ok[i, :2] = fit_ok[i, :2] = True
            r_bits[i, 5:7] = np.minimum(r_bits[i, 5:7], raw[i, 0, 0] // 8)
            r_bits[i, :5] = r_bits[i, 7:] = BIG
        elif kind == 4 and AC >= 1:        # fixed order 2 ties LPC 0
            f_ok[i, 2] = cand_ok[i, 0] = fit_ok[i, 0] = True
            lpc_hdr = ovh[i] + 9 + order_all[i, 5] * (prec[i, 0]
                                                      + bps_eff[i])
            cost = raw[i, 0, 0] // 10
            r_bits[i, [0, 1, 3, 4] + list(range(6, C))] = BIG
            r_bits[i, 5] = np.maximum(r_bits[i, 5], cost)
            r_bits[i, 5, 0] = cost
            r_bits[i, 2] = np.maximum(r_bits[i, 2],
                                      cost + lpc_hdr - hdr[i, 2])
            r_bits[i, 2, L - 1] = cost + lpc_hdr - hdr[i, 2]
        elif kind == 5:                    # fixed order 1 ties verbatim
            f_ok[i, 1] = True
            verb = ovh[i] + N * bps_eff[i]
            r_bits[i] = np.maximum(r_bits[i], verb)
            r_bits[i, 1, 0] = verb - hdr[i, 1]
    r_bits = np.minimum(r_bits, BIG)
    shape = lambda a, *tail: a.reshape((B, CH) + tail)   # noqa: E731
    return {"x": shape(x.astype(np.int64 if x64 else np.int32), N),
            "bps_eff": shape(bps_eff), "wasted": shape(wasted),
            "res_all": shape(res, C, N),
            "order_all": shape(order_all.astype(np.int32), C),
            "f_ok": shape(f_ok, 5), "cand_ok": shape(cand_ok, AC),
            "fit_ok": shape(fit_ok, AC),
            "prec": shape(prec.astype(np.int32), AC),
            "qc": shape(qc.astype(np.int32), AC, 32),
            "qshift": shape(qshift.astype(np.int32), AC),
            "r_bits": shape(r_bits.astype(np.int32), C, L),
            "r_ks": shape(r_ks.astype(np.int32), C, L, P),
            "r_rice2": shape(r_rice2, C, L)}


def select_cases() -> list:
    """[(label, case)]: a case is select_batch's arrays with "N"."""
    out = []

    def add(label, N, **kw):
        case = select_batch(len(out) + 1, N=N, **kw)
        case.update(N=N)
        out.append((label, case))

    add("-5: 1 LPC candidate, N=4096, P=32", 4096, B=4, CH=4, AC=1,
        max_po=5)
    add("-8: 9 candidates, N=4608, P=8", 4608, B=2, CH=6, AC=9, max_po=3)
    add("-e -p: 132 candidates, N=1152, P=128", 1152, B=1, CH=6, AC=132,
        max_po=7)
    add("AC = 0 (-0..-2), N=4096", 4096, B=2, CH=6, AC=0, max_po=4)
    add("N=4: fixed orders past N, one partition", 4, B=2, CH=6, AC=3,
        max_po=0)
    add("N=16, P=16", 16, B=2, CH=6, AC=2, max_po=4)
    add("N=33, odd length: scalar copies", 33, B=2, CH=6, AC=4, max_po=0)
    add("RICE2 at 24 bits, N=4096", 4096, B=1, CH=6, AC=3, max_po=6,
        bps=24, rice2=True)
    add("33-bit side: int64 signals and warm-up", 4096, B=1, CH=6, AC=2,
        max_po=5, bps=33, x64=True, rice2=True)
    add("N=32768, -r 15: 32768 parameters a level", 32768, B=1, CH=2,
        AC=1, max_po=15)
    return out


def as_select_inputs(case: dict, device):
    """select_and_realize's arguments on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
                 for k in SELECT_KEYS)
