"""Synthetic inputs for kernels K6 (the LPC coefficient stage,
csrc/lpc_coeffs.cu) and K7 (the Rice cost table, csrc/rice_cost.cu), made
from a seed with numpy.

Each case pins a corner of the plain versions (models/subframe.py
lpc_candidates_plain and _rice_cost_plain) that the encoder's real
batches rarely reach.

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

chip_smoke.py and the card-only tests hold K6 and K7 against their plain
versions on them; the CPU tests hold the plain versions against
flac_tpu's on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..config import EncoderConfig


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
