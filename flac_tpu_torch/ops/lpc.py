"""LPC analysis and residual ops, batched over subframes and candidates.

Port of the encode half of flac_tpu/ops/lpc.py (the reference's
src/libFLAC/lpc.c and window.c): the window bank is a precomputed host
tensor; the encoder's windowed autocorrelation (window_autocorrelation:
K11 on the card, autocorrelation_plain on the CPU) sums flac_tpu's blocked
Gram product in a fixed order; Levinson-Durbin runs all
orders as a Python loop over the order, vectorized over every subframe;
quantization mirrors the reference's error-feedback rounding
(lpc.c:220-314) as a 32-step loop.  Levinson's inner sum runs in the
reference's order, one product at a time (see levinson_all_orders).

The apodization search follows the reference's subdivide_tukey scheme
(stream_encoder.c:4293-4393): autocorrelations are computed per *window*
and punchout candidates are formed by subtracting partial-window
autocorrelations from the root's — a [num_candidates, num_windows] +1/-1
combination matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import constant
from ..format import MAX_LPC_ORDER, SUBFRAME_LPC_QLP_SHIFT_LEN
from . import autoc_cuda

MAX_SHIFT = (1 << (SUBFRAME_LPC_QLP_SHIFT_LEN - 1)) - 1   # 15
MIN_SHIFT = -MAX_SHIFT - 1                                 # -16


# ---------------------------------------------------------------------------
# Window bank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ApodizationBank:
    """Precomputed windows plus the autocorrelation combination matrix.

    windows: [W, N] float32 numpy — windows whose autocorrelation is computed
    combine: [A, W] float32 numpy (+1/-1/0) — candidate a's autocorrelation
             is combine[a] @ window_autocorrs (punchouts = root - partial,
             stream_encoder.c:4369-4375)
    names:   candidate labels
    """
    windows: np.ndarray
    combine: np.ndarray
    names: tuple
    # device -> (windows, combine) tensors, see on()
    _tensors: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    def on(self, device: torch.device):
        """(windows [W, N] float32, combine [A, W] float64) as tensors on
        `device`, copied there once a device and kept with the bank."""
        dev = torch.device(device)
        t = self._tensors.get(dev)
        if t is None:
            t = self._tensors[dev] = (
                torch.as_tensor(self.windows, device=dev),
                torch.as_tensor(self.combine, device=dev).to(torch.float64))
        return t


def build_apodization_bank(blocksize: int, specs: tuple) -> ApodizationBank:
    """specs: tuple of raw `-A` strings like ('tukey(5e-1)',
    'subdivide_tukey(3)') — the 15-family mini-language of
    FLAC__stream_encoder_set_apodization, parsed by ops/windows.py."""
    from . import windows as windows_mod
    canon = windows_mod.parse_specs(";".join(specs))
    wins, combine, names = windows_mod.expand_bank(blocksize, canon)
    return ApodizationBank(windows=wins, combine=combine, names=names)


# ---------------------------------------------------------------------------
# Autocorrelation
# ---------------------------------------------------------------------------

def autocorrelation(windowed, max_lag: int, acc_dtype=torch.float64,
                    block: int = 128):
    """autoc[..., l] = sum_n d[n] * d[n+l] for l in 0..max_lag.

    windowed: [..., N] float32 (windowed signal)
    Returns [..., max_lag+1] in acc_dtype.

    The reference accumulates float32 products in float64 (lpc.c:110-174).
    The default path takes f32 partial sums over blocks of ~128 samples and
    adds them in f64 (the blocked Gram product below when N is a multiple
    of 128); relative error ~1e-5 of autoc[0], far inside what survives
    coefficient quantization.  block=1 gives the full-f64 accumulation.
    """
    if block == 1:
        d = windowed.to(acc_dtype)
        outs = []
        for lag in range(max_lag + 1):
            prod = d * d if lag == 0 else d[..., :-lag] * d[..., lag:]
            outs.append(prod.sum(dim=-1))
        return torch.stack(outs, dim=-1)
    N = windowed.shape[-1]
    if N % 128 == 0 and N >= 256:
        return autocorrelation_gram(windowed, max_lag, acc_dtype)
    pad = (-N) % block
    d = torch.nn.functional.pad(windowed, (0, pad)) if pad else windowed
    Np = N + pad
    outs = []
    for lag in range(max_lag + 1):
        if lag == 0:
            prod = d * d
        else:
            shifted = torch.nn.functional.pad(d[..., lag:], (0, lag))
            prod = d * shifted
        partial = prod.reshape(prod.shape[:-1] + (Np // block, block)).sum(-1)
        outs.append(partial.to(acc_dtype).sum(dim=-1))
    return torch.stack(outs, dim=-1)


def autocorrelation_gram(windowed, max_lag: int, acc_dtype=torch.float64):
    """Autocorrelation as a blocked Gram matrix (one batched f32 matmul).

    Frame the signal into Nb = N/F non-overlapping blocks extended by
    max_lag samples from the next block; then

        P[i, j] = sum_b frames[b, i] * frames[b, j]   (i < F, j < F+L)
        autoc[l] = sum_i P[i, i + l]                  (l-th diagonal)

    with the diagonal sums in f64.  A plain product outside any kernel:
    torch.matmul in full float32 (TF32 is off, see the package init).
    """
    N = windowed.shape[-1]
    L = max_lag
    F = 128
    Nb = N // F
    lead = tuple(windowed.shape[:-1])
    blocks = windowed.reshape(lead + (Nb, F))
    # tail[b, :L] = blocks[b+1, :L]; zero for the last block
    tail = torch.nn.functional.pad(blocks[..., 1:, :L], (0, 0, 0, 1))
    frames = torch.cat([blocks, tail], dim=-1)           # [..., Nb, F+L]
    P = torch.matmul(blocks.transpose(-1, -2), frames)   # [..., F, F+L]
    outs = [torch.diagonal(P, offset=lag, dim1=-2, dim2=-1)
            .to(acc_dtype).sum(dim=-1) for lag in range(L + 1)]
    return torch.stack(outs, dim=-1)


# window_autocorrelation's arithmetic, as K11 runs it (csrc/window_autoc.cu):
# column t of AUTOC_COLUMNS sums its blocks' products, the columns meet in
# a tree a warp of AUTOC_WARP columns at a time
AUTOC_COLUMNS = 128
AUTOC_WARP = 32


def window_autocorrelation(x, windows, combine, max_lag: int):
    """The autocorrelations of every apodization of every signal row: each
    window's autocorrelation of the windowed row, combined by `combine`.

    x:       [B, CH, N] int32 (int64 on the 33-bit side)
    windows: [W, N] float32 (ApodizationBank.on)
    combine: [A, W] float64
    Returns autoc [B, CH, A, max_lag + 1] float64.

    Dispatches on x's device: autocorrelation_plain for a CPU tensor,
    kernel K11 (ops/autoc_cuda.py) for a CUDA tensor (it launches or
    raises; there is no fallback).  Both follow autocorrelation_plain's
    order of operations, so they agree bit for bit.
    """
    if x.device.type == "cuda":
        return autoc_cuda.window_autoc(x, windows, combine, max_lag)
    return autocorrelation_plain(x, windows, combine, max_lag)


def _fma_float32(a, b, c):
    """a * b + c rounded once to float32 (the fused multiply-add of a
    float32 pipe), for float32 values held in float64 tensors: the
    product is exact in float64, TwoSum gives the sum's rounding error e,
    and e breaks the one case where rounding the float64 sum to float32 is
    not rounding the exact value: a sum that lands on a midpoint between
    two float32 values (every such midpoint is a float64 value, so the
    exact value is on the float64 sum's side of any other)."""
    p = a * b
    s = p + c
    sb = s - p
    e = (p - (s - sb)) + (c - sb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    tie = (r64 != s) & (s - r64 == other.to(torch.float64) - s)
    away = tie & (e != 0) & ((e > 0) == (s > r64))
    return torch.where(away, other, r).to(torch.float64)


def autocorrelation_plain(x, windows, combine, max_lag: int):
    """window_autocorrelation op by op (K11's plain version), in the order
    K11 follows bit for bit.  It is flac_tpu's blocked Gram product
    (autocorrelation_mxu: P[i, i + l] = the float32 sum over the blocks b
    of d[bF + i] * d[bF + i + l], F = 128, then the diagonal summed in
    float64) with every sum in a fixed order:

    - d[w, n] = float32(x[n]) * windows[w, n], rounded to float32, zero
      past N;
    - column t of AUTOC_COLUMNS: p = 0, then for ascending b,
      p = fma(d[n], d[n + l], p) rounded once to float32 with
      n = b * AUTOC_COLUMNS + t (the float32 multiply-add of a matrix
      product, as the BLAS and XLA sum flac_tpu's Gram product;
      _fma_float32 emulates it exactly);
    - autoc_w[l] = a fixed tree over the columns' float64(p): the halves
      of each warp of AUTOC_WARP columns (pairs t, t + 16, then t + 8,
      ...), then the halves of the warps' sums;
    - autoc[a] = the sum over ascending w of combine[a, w] * autoc_w[w],
      each product and sum rounded in float64.

    Its error is flac_tpu's kind: float32 sums over the N / 128 blocks of
    a column (~1e-5 of autoc[0] at most, flac_tpu's docstring).  Summing
    in float64 instead (libFLAC's lpc.c:110-174) would be closer to the
    exact value, but it moves the stream tests' LPC choices away from
    flac_tpu's on their borderline frames, and so does a multiply and an
    add each rounded to float32.
    """
    T, V = AUTOC_COLUMNS, AUTOC_WARP
    lead = tuple(x.shape[:-1])
    N = x.shape[-1]
    W = windows.shape[0]
    d = x.to(torch.float32)[..., None, :] * windows     # [..., W, N]
    K = -(-N // T)
    d = torch.nn.functional.pad(d, (0, K * T - N + max_lag)).to(
        torch.float64)
    lags = []
    for lag in range(max_lag + 1):
        a = d[..., :K * T].reshape(lead + (W, K, T))
        b = d[..., lag:lag + K * T].reshape(lead + (W, K, T))
        acc = torch.zeros_like(a[..., 0, :])
        for k in range(K):
            acc = _fma_float32(a[..., k, :], b[..., k, :], acc)
        acc = acc.reshape(lead + (W, T // V, V))
        h = V // 2
        while h:
            acc = acc[..., :h] + acc[..., h:2 * h]
            h //= 2
        acc = acc[..., 0]
        h = T // V // 2
        while h:
            acc = acc[..., :h] + acc[..., h:2 * h]
            h //= 2
        lags.append(acc[..., 0])
    autoc_w = torch.stack(lags, dim=-1)                 # [..., W, O+1]
    out = torch.zeros(lead + (combine.shape[0], max_lag + 1),
                      dtype=torch.float64, device=x.device)
    for w in range(W):
        out = out + combine[:, w, None] * autoc_w[..., None, w, :]
    return out


# ---------------------------------------------------------------------------
# Levinson-Durbin — all orders at once
# ---------------------------------------------------------------------------

def levinson_all_orders(autoc, max_order: int):
    """Vectorized Levinson-Durbin returning predictor coefficients for every
    order 1..max_order (FLAC__lpc_compute_lp_coefficients, lpc.c:176-218).

    autoc: [..., max_order+1] float64
    Returns:
      coeffs [..., max_order, MAX_LPC_ORDER] float32 — predictor (negated
        FIR) coefficients for each order, zero-padded
      pred_err [..., max_order] — modeling error per order
      order_valid [..., max_order] bool — False for orders past an exact fit
        (err==0 truncation, lpc.c:213-216) or when autoc[0]==0
    """
    O = max_order
    dev = autoc.device
    batch = tuple(autoc.shape[:-1])
    jidx = torch.arange(MAX_LPC_ORDER, device=dev)

    lpc = torch.zeros(batch + (MAX_LPC_ORDER,), dtype=autoc.dtype, device=dev)
    err = autoc[..., 0]
    dead = err == 0
    lpcs, errs, was_dead = [], [], []
    for i in range(O):
        # r = -(autoc[i+1] + sum_{j<i} lpc[j] * autoc[i-j]) / err, the sum
        # taken one product at a time from j = 0 up, the order of the
        # reference's loop (lpc.c:176-218): a reduction tree on the card
        # would round in an order that kernel K6 (csrc/lpc_coeffs.cu)
        # cannot follow, and K6 must equal this bit for bit
        mask = jidx < i
        prod = lpc[..., :i] * autoc[..., i - jidx[:i]]   # lpc[j]*autoc[i-j]
        s = torch.zeros(batch, dtype=autoc.dtype, device=dev)
        for j in range(i):
            s = s + prod[..., j]
        safe_err = torch.where(err == 0, 1, err)
        r = -(autoc[..., i + 1] + s) / safe_err
        # lpc'[j] = lpc[j] + r * lpc[i-1-j] for j < i; lpc'[i] = r
        lpc_rev = lpc[..., torch.clamp(i - 1 - jidx, 0, MAX_LPC_ORDER - 1)]
        lpc_new = torch.where(mask, lpc + r[..., None] * lpc_rev, lpc)
        lpc_new = torch.where(jidx == i, r[..., None], lpc_new)
        err_new = err * (1 - r * r)
        lpcs.append(torch.where(dead[..., None], 0, lpc_new))
        errs.append(err_new)
        was_dead.append(dead)
        dead = dead | (err_new == 0)   # orders AFTER an exact fit die
        lpc, err = lpc_new, err_new
    coeffs = (-torch.stack(lpcs, dim=-2)).to(torch.float32)
    return coeffs, torch.stack(errs, dim=-1), ~torch.stack(was_dead, dim=-1)


def ilog2(v):
    """floor(log2(v)) for integers in 1..32 (bitmath.c:63)."""
    v = v.to(torch.int32)
    return ((v > 1).to(torch.int32) + (v > 3) + (v > 7) + (v > 15)
            + (v > 31))


def estimate_best_order(errs, N: int, overhead_bits_per_order):
    """Guess the cheapest LPC order from Levinson modeling errors.

    Mirrors FLAC__lpc_compute_best_order (lpc.c:1608-1630): estimated
    bits(o) = max(0, 0.5*log2(0.5/N * err[o])) * (N - o)
              + o * overhead_bits_per_order, argmin over o (first wins).

    errs: [..., O] f64 prediction error per order (order o at index o-1);
          err < 0 (float-resolution artifacts) scores 1e32 like the
          reference.
    overhead_bits_per_order: [...] (subframe bps + qlp precision).
    Returns (order [...] int32 in 1..O, est_bps_at_guess [...] f64 — the
    "don't even try" signal recomputed at scale 0.5/(N-order) like the
    caller's check at stream_encoder.c:4227-4229).
    """
    O = errs.shape[-1]
    orders = torch.arange(1, O + 1, dtype=torch.float64, device=errs.device)

    def est_bps(err, scale):
        bps = 0.5 * torch.log2(torch.where(err > 0, err * scale, 1.0))
        return torch.where(err > 0, torch.clamp(bps, min=0.0),
                           torch.where(err < 0, 1e32, 0.0))

    bits = (est_bps(errs, 0.5 / N) * (N - orders)
            + orders * overhead_bits_per_order[..., None].to(torch.float64))
    idx = bits.argmin(dim=-1)
    guess = (idx + 1).to(torch.int32)
    err_at = torch.gather(errs, -1, idx[..., None])[..., 0]
    est_at = est_bps(err_at, 0.5 / (N - guess.to(torch.float64)))
    return guess, est_at


# ---------------------------------------------------------------------------
# Coefficient quantization (error-feedback rounding)
# ---------------------------------------------------------------------------

# exact 2.0**e values precomputed on host (an exp2/ldexp shortcut can be an
# ulp off on some backends); a gather from this table is exact everywhere
_POW2_MIN, _POW2_MAX = -1075, 1024
with np.errstate(over="ignore"):   # inf at the top entry is intentional
    _POW2_TABLE = np.ldexp(1.0, np.arange(_POW2_MIN, _POW2_MAX + 1))


def _pow2(e):
    """Exact 2.0**e (f64) for integer tensors e, saturating at the f64
    range."""
    table = constant("pow2", e.device,
                     lambda dev: torch.as_tensor(_POW2_TABLE, device=dev))
    idx = torch.clamp(e.to(torch.int64) - _POW2_MIN, 0, table.shape[0] - 1)
    return table[idx]


def quantize_coefficients(coeffs, orders, precision):
    """Quantize float predictor coefficients per lpc.c:220-314.

    coeffs:    [..., MAX_LPC_ORDER] float32 candidate coefficients (zero
               beyond the candidate's order)
    orders:    [...] int32 — actual order per candidate (1..32)
    precision: [...] int32 — qlp precision per candidate (after the
               evaluate_lpc_ clamp, stream_encoder.c:4591-4595)

    Returns (qcoeffs int32 [..., 32], shift int32 [...], valid bool [...]).
    """
    c = coeffs.to(torch.float64)
    prec = precision.to(torch.int32)
    jidx = torch.arange(MAX_LPC_ORDER, device=c.device)
    in_order = jidx < orders[..., None]                 # [..., 32]

    cmax = torch.where(in_order, c.abs(), 0).max(dim=-1).values
    valid = cmax > 0

    # log2cmax = floor(log2(cmax)) (equals the reference's frexp
    # exponent-1, lpc.c:252-255), via log2 repaired exactly at the
    # boundaries with exact power-of-two comparisons
    safe = torch.where(valid, cmax, 1.0)
    e0 = torch.floor(torch.log2(safe)).to(torch.int32)
    e0 = torch.where(_pow2(e0) > safe, e0 - 1, e0)
    log2cmax = torch.where(_pow2(e0 + 1) <= safe, e0 + 1, e0)
    shift = (prec - 1) - log2cmax - 1
    shift = torch.clamp(shift, max=MAX_SHIFT)
    valid = valid & (shift >= MIN_SHIFT)
    # negative shift: scale coefficients down and emit shift 0
    # (lpc.c:283-311); both branches reduce to multiplying by 2^shift
    scale = _pow2(shift)
    out_shift = torch.clamp(shift, min=0)

    qmax = ((1 << (prec - 1)) - 1).to(torch.float64)
    qmin = -(qmax + 1)

    error = torch.zeros(c.shape[:-1], dtype=torch.float64, device=c.device)
    qs = []
    for j in range(MAX_LPC_ORDER):
        err = error + c[..., j] * scale
        # round half away from zero, not torch.round's half-to-even
        q = torch.where(in_order[..., j],
                        torch.sign(err) * torch.floor(err.abs() + 0.5), 0.0)
        q = torch.minimum(torch.maximum(q, qmin), qmax)
        error = torch.where(in_order[..., j], err - q, error)
        qs.append(q.to(torch.int32))
    return torch.stack(qs, dim=-1), out_shift.to(torch.int32), valid


# ---------------------------------------------------------------------------
# Residual computation
# ---------------------------------------------------------------------------

def lpc_residual(x, qcoeffs, shift, orders, bps_eff, mode: str,
                 max_order: int = MAX_LPC_ORDER):
    """residual[..., a, n] = x[n] - (sum_j q[a,j] * x[n-1-j]) >> shift[a]
    for n >= order[a]; positions n < order are zeroed.

    x:        [..., N] int32 signal (wasted-bits-shifted: |x| < 2^(bps_eff-1))
    qcoeffs:  [..., A, 32] int32 (zero beyond each candidate's order)
    shift:    [..., A] int32
    orders:   [..., A] int32
    bps_eff:  [...] int32 — effective bps bound of x
    mode:     "i32" — int32 accumulation; candidates whose accumulator or
              residual could exceed int32 are invalidated via the exact
              static range analysis of the reference's decoder-width pick
              (FLAC__lpc_max_prediction_before_shift_bps /
              max_residual_bps, lpc.c:942-976).  "f64" — exact f64
              accumulation (products <= 2^47, sums <= 2^52), for hi-res.
    max_order: the highest order any candidate can have, a Python int
              from the caller's configuration (min(32, N-1,
              cfg.max_lpc_order)): the tap loop stops there, since the
              quantized coefficients past a candidate's order are zero.
              A static bound, as the reference's: nothing is read back
              from the device (the default, 32, is the reference's loop).

    Returns (residual [..., A, N] int32, valid [..., A] bool).
    """
    N = x.shape[-1]
    dev = x.device
    n_idx = torch.arange(N, dtype=torch.int32, device=dev)
    mask = n_idx >= orders[..., None]                   # [..., A, N]
    max_j = min(MAX_LPC_ORDER, max(N - 1, 1), qcoeffs.shape[-1],
                max(max_order, 1))

    # exact candidate range analysis in f64 (all quantities < 2^50)
    sum_abs_q = qcoeffs.abs().to(torch.float64).sum(dim=-1)
    amp = _pow2(bps_eff - 1)[..., None]                 # [..., 1]
    pred_bound = sum_abs_q * amp
    res_bound = amp + torch.floor(pred_bound * _pow2(-shift))
    fits = (pred_bound < float(2 ** 31)) & (res_bound < float(2 ** 31))

    def accumulate(xa, qa):
        xp = torch.nn.functional.pad(xa, (max_j, 0))
        pred = None
        for j in range(max_j):
            lag = xp[..., max_j - 1 - j:max_j - 1 - j + N]
            term = qa[..., :, j][..., None] * lag[..., None, :]
            pred = term if pred is None else pred + term
        return pred

    if mode == "i32":
        pred = accumulate(x, qcoeffs) >> shift[..., None]
        res = x[..., None, :] - pred
        return torch.where(mask, res, 0), fits
    if mode == "f64":
        pred = accumulate(x.to(torch.float64), qcoeffs.to(torch.float64))
        pred = torch.floor(pred * _pow2(-shift[..., None]))
        res = x.to(torch.float64)[..., None, :] - pred
        res = torch.where(mask, res, 0)
        # f64 is exact here, so gate on the actual residual range (the
        # reference's limit_residual behavior) — tighter than the bound
        valid = res.abs().max(dim=-1).values < float(2 ** 31)
        return res.to(torch.int32), valid
    raise ValueError(f"unknown mode {mode}")
