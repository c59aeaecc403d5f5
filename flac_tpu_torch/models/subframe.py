"""Subframe model search: order-guessed candidate grid, one stacked pass.

Port of flac_tpu/models/subframe.py.  Every candidate — CONSTANT,
VERBATIM, FIXED orders 0-4, and one guessed (order, coeffs) per
apodization (every order with -e, every precision with -p) — lands on one
stacked candidate axis; residuals and *exact* partitioned-Rice costs are
computed for all of them at once, and one argmin (first index wins ties)
picks the winner.  The reference evaluates one model at a time
(process_subframe_, stream_encoder.c:4045-4290).

On a CUDA device each stage is a hand-written kernel: the windowed
autocorrelation (lpc.window_autocorrelation: K11, ops/autoc_cuda.py), the
LPC coefficient stage (lpc_candidates: K6, ops/lpc_cuda.py),
the candidate residuals (candidate_residuals: K8, ops/residuals_cuda.py),
the Rice cost table (_rice_cost: K7, ops/rice_cost_cuda.py) and the
select and realize (select_and_realize: K9, ops/select_cuda.py); their
plain versions (lpc_candidates_plain, candidate_residuals_plain,
_rice_cost_plain, select_and_realize_plain) run on the CPU.

CH indexes the channel *candidates* (left, right, mid, side for stereo),
not the final stream channels; the stereo assignment picks among them
afterwards (models/stereo.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import format as fmt
from ..config import EncoderConfig
from ..device import constant
from ..ops import fixed as fixed_ops
from ..ops import lpc as lpc_ops
from ..ops import lpc_cuda, residuals_cuda, rice_cost_cuda, \
    select_cuda
from ..ops import rice as rice_ops

BIG = rice_ops.BIG


class SubframeChoice(NamedTuple):
    """Realized best subframe per (frame, channel-candidate)."""
    bits: torch.Tensor        # [B, CH] int32 total subframe bits
    type_: torch.Tensor       # [B, CH] int32 (fmt.SUBFRAME_TYPE_*)
    order: torch.Tensor       # [B, CH] int32 predictor order (0 const/verb)
    wasted: torch.Tensor      # [B, CH] int32
    bps_eff: torch.Tensor     # [B, CH] int32 subframe bps after wasted shift
    qcoeffs: torch.Tensor     # [B, CH, 32] int32 (LPC only)
    shift: torch.Tensor       # [B, CH] int32 quantization shift
    precision: torch.Tensor   # [B, CH] int32 qlp precision (LPC only)
    warmup: torch.Tensor      # [B, CH, 32] post-shift signal head (x's dtype)
    residual: torch.Tensor    # [B, CH, N] int32 (zero at n < order)
    po: torch.Tensor          # [B, CH] int32 partition order
    params: torch.Tensor      # [B, CH, P] int32 Rice parameter per partition
    use_rice2: torch.Tensor   # [B, CH] bool — 5-bit parameter method


def _max_po_limit(order, N: int, max_po: int):
    """Highest partition order with (N>>po) > order (format.c:541-553)."""
    lens = constant(("partition lengths", N, max_po), order.device,
                    lambda dev: torch.tensor(
                        [N >> po for po in range(max_po + 1)],
                        dtype=torch.int32, device=dev))
    ok = lens > order[..., None]
    return ok.to(torch.int32).sum(dim=-1) - 1


def _rice_cost(res, order, N: int, max_po: int, cfg: EncoderConfig):
    """Residual-coding cost per partition order, RICE/RICE2 aware.

    res:   [..., N] int32 residuals (zero at n < order)
    order: [...] int32 predictor order
    Returns (bits [..., L] incl. the 6 method/order field bits, BIG where
             the order is out of [min_po, limit],
             params [..., L, P], rice2 [..., L] bool).

    Dispatches on the residuals' device: the plain version below for a
    CPU tensor, kernel K7 (ops/rice_cost_cuda.py) for a CUDA tensor (it
    launches or raises; there is no fallback).
    """
    if res.device.type == "cuda":
        return rice_cost_cuda.rice_cost(res, order, N, max_po, cfg)
    return _rice_cost_plain(res, order, N, max_po, cfg)


def _rice_cost_plain(res, order, N: int, max_po: int, cfg: EncoderConfig):
    """_rice_cost op by op: zigzag, then partition_cost_table once (RICE)
    or twice (RICE and RICE2), the partition-order limits and the 6 field
    bits.  K7's plain version."""
    u = rice_ops.zigzag(res)
    esc = cfg.do_escape_coding
    if cfg.rice_param_limit <= 15:
        bits, ks = rice_ops.partition_cost_table(
            u, order, N, max_po, kmax=14, plen=4, escape=esc)
        rice2 = torch.zeros(bits.shape, dtype=torch.bool, device=u.device)
    else:
        # RICE2 is chosen iff it is cheaper for the whole subframe (the
        # reference pays 5-bit params whenever any partition needs k>=15,
        # stream_encoder.c:4786-4794; exact min here is never worse)
        bits4, ks4 = rice_ops.partition_cost_table(
            u, order, N, max_po, kmax=14, plen=4, escape=esc)
        bits5, ks5 = rice_ops.partition_cost_table(
            u, order, N, max_po, kmax=30, plen=5, escape=esc)
        rice2 = bits5 < bits4
        bits = torch.minimum(bits4, bits5)
        ks = torch.where(rice2[..., None], ks5, ks4)
    limit = _max_po_limit(order, N, max_po)
    po_idx = torch.arange(bits.shape[-1], device=u.device)
    # the reference searches partition orders in [min_po, max_po]
    # (find_best_partition_order_)
    ok = (po_idx <= limit[..., None]) & (
        po_idx >= cfg.min_residual_partition_order)
    bits = torch.where(ok, bits + 2 + 4, BIG)
    return bits, ks, rice2


def _select_c(stack_arr, win_c):
    """Select along the candidate axis (axis 2).

    stack_arr: [B, CH, C, ...]; win_c: [B, CH] int32 in [0, C).
    Returns [B, CH, ...].
    """
    idx = win_c.long()[:, :, None]
    while idx.ndim < stack_arr.ndim:
        idx = idx[..., None]
    idx = idx.expand(stack_arr.shape[:2] + (1,) + stack_arr.shape[3:])
    return torch.gather(stack_arr, 2, idx)[:, :, 0]


def lpc_candidates(autoc, bps_eff, N: int, cfg: EncoderConfig):
    """The LPC candidates of every (frame, channel candidate) from its
    apodizations' autocorrelations: Levinson-Durbin over orders 1..O, the
    order guess (every order with -e), the "don't even try" test, the
    precision (every legal one with -p) and the quantized coefficients.

    autoc:   [B, CH, A, O+1] float64 (O = min(max_lpc_order, N-1) > 0)
    bps_eff: [B, CH] int32
    Returns (qc [B, CH, AC, 32] int32, qshift [B, CH, AC] int32,
             cand_order [B, CH, AC] int32, prec [B, CH, AC] int32,
             ok [B, CH, AC] bool): AC = A, times O with -e, times the
    precisions with -p (candidate a*O + o - 1 with -e, then its
    precisions consecutive); ok is the order's validity, the estimate
    test and the quantizer's.

    Dispatches on autoc's device: the plain version below for a CPU
    tensor, kernel K6 (ops/lpc_cuda.py) for a CUDA tensor (it launches or
    raises; there is no fallback).
    """
    if autoc.device.type == "cuda":
        return lpc_cuda.lpc_candidates(autoc, bps_eff, N, cfg)
    return lpc_candidates_plain(autoc, bps_eff, N, cfg)


def lpc_candidates_plain(autoc, bps_eff, N: int, cfg: EncoderConfig):
    """lpc_candidates op by op (K6's plain version)."""
    B, CH, A = autoc.shape[:3]
    O = autoc.shape[-1] - 1
    dev = autoc.device
    bps32 = bps_eff
    coeffs, errs, order_ok = lpc_ops.levinson_all_orders(autoc, O)
    # coeffs [B,CH,A,O,32] f32, errs [B,CH,A,O] f64

    if cfg.do_exhaustive_model_search:
        # -e: every order of every apodization is a candidate
        AC = A * O
        cand_coeffs = coeffs.reshape(B, CH, AC, 32)
        cand_order = torch.arange(1, O + 1, dtype=torch.int32,
                                  device=dev).expand(B, CH, A, O
                                                     ).reshape(B, CH, AC)
        cand_ok = order_ok.reshape(B, CH, AC)
        # "don't even try" signal per candidate (st..c:4227-4229)
        ordf = cand_order.to(torch.float64)
        errf = errs.reshape(B, CH, AC)
        scale = 0.5 / (N - ordf)
        est = 0.5 * torch.log2(torch.where(errf > 0, errf * scale, 1.0))
        est = torch.where(errf > 0, torch.clamp(est, min=0.0),
                          torch.where(errf < 0, 1e32, 0.0))
    else:
        AC = A
        guess, est = lpc_ops.estimate_best_order(
            errs, N, bps32[..., None] + cfg.qlp_coeff_precision)
        gidx = (guess - 1).long()
        cand_coeffs = torch.gather(
            coeffs, 3, gidx[..., None, None].expand(B, CH, A, 1, 32)
        )[:, :, :, 0]
        cand_order = guess                    # [B, CH, A]
        cand_ok = torch.gather(order_ok, -1, gidx[..., None])[..., 0]
    # skip candidates whose estimated rate already exceeds raw bps
    cand_ok = cand_ok & (est < bps32[..., None].to(torch.float64))

    if cfg.do_qlp_coeff_prec_search:
        # -p: every legal precision becomes its own candidate
        # (evaluate_lpc over min..max precision, st..c:4231-4245)
        nP = (fmt.MAX_QLP_COEFF_PRECISION
              - fmt.MIN_QLP_COEFF_PRECISION + 1)
        prec_grid = torch.arange(fmt.MIN_QLP_COEFF_PRECISION,
                                 fmt.MAX_QLP_COEFF_PRECISION + 1,
                                 dtype=torch.int32, device=dev)
        clamp = torch.where(
            bps32[..., None] <= 17,
            torch.clamp(32 - bps32[..., None]
                        - lpc_ops.ilog2(cand_order),
                        min=fmt.MIN_QLP_COEFF_PRECISION),
            fmt.MAX_QLP_COEFF_PRECISION)                 # [B, CH, AC]
        ok_p = prec_grid <= clamp[..., None]             # [B,CH,AC,nP]
        cand_coeffs = torch.repeat_interleave(
            cand_coeffs, nP, dim=2, output_size=AC * nP)
        cand_order = torch.repeat_interleave(
            cand_order, nP, dim=2, output_size=AC * nP)
        cand_ok = (cand_ok[..., None] & ok_p).reshape(B, CH, AC * nP)
        prec = prec_grid.expand(B, CH, AC, nP).reshape(B, CH, AC * nP)
    else:
        # qlp precision clamp (evaluate_lpc_subframe_, st..c:4591-4595)
        static_prec = cfg.qlp_coeff_precision
        prec = torch.where(
            bps32[..., None] <= 17,
            torch.clamp(32 - bps32[..., None]
                        - lpc_ops.ilog2(cand_order), max=static_prec),
            static_prec).to(torch.int32)    # [B, CH, AC]

    qc, qshift, q_ok = lpc_ops.quantize_coefficients(
        cand_coeffs, cand_order, prec)        # [B,CH,AC,32] ...
    return qc, qshift, cand_order, prec, cand_ok & q_ok


def candidate_residuals(x, qc, qshift, cand_order, bps_eff,
                        fixed_wide: bool, lpc_mode: str, max_order: int):
    """The residuals of every Rice-coded candidate of every (frame, channel
    candidate): the five fixed orders, then the LPC candidates.

    x:          [B, CH, N] int32 signal (int64 in the 33-bit side
                configuration, which takes the wide fixed and the "f64"
                LPC paths)
    qc:         [B, CH, AC, 32] int32 quantized coefficients, zero past
                each candidate's order (the quantizer's output); AC may
                be 0 (presets without LPC)
    qshift, cand_order: [B, CH, AC] int32 (shifts >= 0, as the quantizer
                clamps them)
    bps_eff:    [B, CH] int32
    fixed_wide: the fixed residuals in exact wide arithmetic with a range
                flag (cfg.max_subframe_bps >= 28), else wrapping int32
    lpc_mode:   lpc_residual's "i32" (<= 17 bits: wrapping int32 and the
                static range analysis) or "f64" (exact, with a range flag)
    max_order:  the highest order any candidate can have (the
                configuration's, a Python int)

    Returns (res_all [B, CH, 5 + AC, N] int32, zero at n < order;
             order_all [B, CH, 5 + AC] int32; f_ok [B, CH, 5] bool, the
             fixed rows' range flags (all true when narrow); fit_ok
             [B, CH, AC] bool, lpc_residual's validity).  A row whose flag
             is false holds no defined residuals (the plain version casts
             out-of-range doubles; K8 keeps their low 32 bits): compare
             such rows by their flags only.

    Dispatches on x's device: the plain version below for a CPU tensor,
    kernel K8 (ops/residuals_cuda.py) for a CUDA tensor (it launches or
    raises; there is no fallback).
    """
    if x.device.type == "cuda":
        return residuals_cuda.candidate_residuals(
            x, qc, qshift, cand_order, bps_eff, fixed_wide, lpc_mode,
            max_order)
    return candidate_residuals_plain(x, qc, qshift, cand_order, bps_eff,
                                     fixed_wide, lpc_mode, max_order)


def candidate_residuals_plain(x, qc, qshift, cand_order, bps_eff,
                              fixed_wide: bool, lpc_mode: str,
                              max_order: int):
    """candidate_residuals op by op (K8's plain version)."""
    B, CH, N = x.shape
    dev = x.device
    AC = qc.shape[2]
    # ---- FIXED orders 0..4 ----
    # int32 when bps < 28 (|res| <= 17 * 2^(bps-1), the reference's
    # accumulator criterion at stream_encoder.c:4097-4107), exact f64
    # above
    n_idx = torch.arange(N, dtype=torch.int32, device=dev)
    forder = torch.arange(5, dtype=torch.int32, device=dev)
    fmask = n_idx[None, :] >= forder[:, None]     # [5, N]
    if fixed_wide:
        fres_w = fixed_ops.fixed_residuals_all(x.to(torch.float64))
        fres_w = torch.where(fmask, fres_w, 0)
        f_ok = fres_w.abs().max(dim=-1).values < float(2 ** 31)
        fres = fres_w.to(torch.int32)
    else:
        fres = torch.where(fmask, fixed_ops.fixed_residuals_all(x), 0)
        f_ok = torch.ones(fres.shape[:-1], dtype=torch.bool, device=dev)
    forder_b = forder.expand(B, CH, 5)
    if AC:
        res_lpc, fit_ok = lpc_ops.lpc_residual(
            x, qc, qshift, cand_order, bps_eff, lpc_mode,
            max_order=max_order)                      # [B,CH,AC,N]
    else:
        res_lpc = torch.zeros((B, CH, 0, N), dtype=torch.int32, device=dev)
        fit_ok = torch.zeros((B, CH, 0), dtype=torch.bool, device=dev)
    res_all = torch.cat([fres, res_lpc], dim=2)       # [B,CH,C,N]
    order_all = torch.cat([forder_b, cand_order], dim=2)
    return res_all, order_all, f_ok, fit_ok


def select_and_realize(x, bps_eff, wasted, res_all, order_all, f_ok,
                       cand_ok, fit_ok, prec, qc, qshift, r_bits, r_ks,
                       r_rice2) -> SubframeChoice:
    """The cheapest of every (frame, channel candidate)'s candidates,
    realized.

    x [B, CH, N] (int32, or int64 on the 33-bit side), bps_eff and
    wasted [B, CH] int32; candidate_residuals' res_all, order_all, f_ok
    and fit_ok; lpc_candidates' cand_ok (its ok), prec, qc and qshift
    ([B, CH, AC, ...], AC may be 0); _rice_cost's r_bits [B, CH, C, L],
    r_ks [B, CH, C, L, P] and r_rice2 [B, CH, C, L] (C = 5 + AC).

    The candidates are [verbatim, constant, fixed 0..4, LPC 0..AC-1]:
    each one's bits (its header and, for the Rice-coded ones, the
    cheapest partition order's cost: BIG where it is not valid), then
    the first-index argmin over them, as torch.argmin and jnp.argmin
    take it; the winner's order, residual row, partition order,
    parameters, RICE2 flag, coefficients, shift and precision, and the
    signal's first 32 samples as the warm-up.  A verbatim or constant
    winner takes the parameters and RICE2 flag of fixed order 0 at
    partition order 0, as the reference's selects do.

    Dispatches on x's device: the plain version below for a CPU tensor,
    kernel K9 (ops/select_cuda.py) for a CUDA tensor (it launches or
    raises; there is no fallback).
    """
    if x.device.type == "cuda":
        out = select_cuda.select_and_realize(
            x, bps_eff, wasted, res_all, order_all, f_ok, cand_ok, fit_ok,
            prec, qc, qshift, r_bits, r_ks, r_rice2)
        return SubframeChoice(wasted=wasted, bps_eff=bps_eff,
                              **dict(zip(select_cuda.OUTPUTS, out)))
    return select_and_realize_plain(x, bps_eff, wasted, res_all, order_all,
                                    f_ok, cand_ok, fit_ok, prec, qc, qshift,
                                    r_bits, r_ks, r_rice2)


def select_and_realize_plain(x, bps_eff, wasted, res_all, order_all, f_ok,
                             cand_ok, fit_ok, prec, qc, qshift, r_bits,
                             r_ks, r_rice2) -> SubframeChoice:
    """select_and_realize op by op (K9's plain version)."""
    B, CH, N = x.shape
    dev = x.device
    AC = qc.shape[2]
    C_rice = 5 + AC
    overhead = 8 + wasted                         # subframe header bits
    bps32 = bps_eff
    forder = torch.arange(5, dtype=torch.int32, device=dev)

    # ---- VERBATIM (always valid) ----
    verb_bits = overhead + N * bps32

    # ---- CONSTANT ----
    is_const = (x == x[..., :1]).all(dim=-1)
    const_bits = torch.where(is_const, overhead + bps32, BIG)

    rice_best = r_bits.min(dim=-1).values         # [B, CH, C]
    po_all = r_bits.argmin(dim=-1).to(torch.int32)

    # header bits per candidate
    fixed_hdr = overhead[..., None] + forder * bps32[..., None]
    ok_fixed = f_ok & (forder < N)
    if AC:
        lpc_hdr = (overhead[..., None] + 4 + 5
                   + order_all[:, :, 5:] * (prec + bps32[..., None]))
        hdr_all = torch.cat([fixed_hdr, lpc_hdr], dim=2)
        ok_all = torch.cat([ok_fixed, cand_ok & fit_ok], dim=2)
    else:
        hdr_all = fixed_hdr
        ok_all = ok_fixed
    total_all = torch.where(ok_all & (rice_best < BIG),
                            hdr_all + torch.clamp(rice_best, max=BIG),
                            BIG)

    # ---- argmin over all candidates ----
    # candidate vector: [verbatim, constant, fixed0..4, lpc_0..AC-1]
    allbits = torch.cat([verb_bits[..., None], const_bits[..., None],
                         total_all], dim=-1)
    win = allbits.argmin(dim=-1).to(torch.int32)  # [B, CH]
    best_bits = allbits.min(dim=-1).values

    is_verb = win == 0
    is_constw = win == 1
    is_fixed = (win >= 2) & (win < 7)
    is_lpc = win >= 7
    has_res = is_fixed | is_lpc
    win_c = torch.clamp(win - 2, 0, C_rice - 1)   # into the rice stack

    type_ = torch.where(
        is_verb, fmt.SUBFRAME_TYPE_VERBATIM, torch.where(
            is_constw, fmt.SUBFRAME_TYPE_CONSTANT, torch.where(
                is_fixed, fmt.SUBFRAME_TYPE_FIXED,
                fmt.SUBFRAME_TYPE_LPC))).to(torch.int32)

    # ---- realize the winner from the per-candidate tables ----
    order = torch.where(has_res, _select_c(order_all, win_c), 0)
    residual = torch.where(has_res[..., None],
                           _select_c(res_all, win_c), 0)
    po = torch.where(has_res, _select_c(po_all, win_c), 0)
    ks_sel = _select_c(r_ks, win_c)               # [B, CH, L, P]
    params = torch.gather(
        ks_sel, 2, po.long()[..., None, None].expand(
            B, CH, 1, ks_sel.shape[-1]))[:, :, 0]     # [B, CH, P]
    r2_sel = _select_c(r_rice2, win_c)            # [B, CH, L]
    use_rice2 = torch.gather(r2_sel, -1, po.long()[..., None])[..., 0]

    if AC:
        lidx = torch.clamp(win - 7, 0, AC - 1)
        qc_win = torch.where(is_lpc[..., None], _select_c(qc, lidx), 0)
        sh_win = torch.where(is_lpc, _select_c(qshift, lidx), 0)
        prec_win = torch.where(is_lpc, _select_c(prec, lidx), 0)
    else:
        qc_win = torch.zeros((B, CH, 32), dtype=torch.int32, device=dev)
        sh_win = torch.zeros((B, CH), dtype=torch.int32, device=dev)
        prec_win = torch.zeros((B, CH), dtype=torch.int32, device=dev)

    if N >= fmt.MAX_LPC_ORDER:
        warmup = x[..., :fmt.MAX_LPC_ORDER]
    else:
        warmup = torch.nn.functional.pad(x, (0, fmt.MAX_LPC_ORDER - N))

    return SubframeChoice(
        bits=best_bits, type_=type_, order=order, wasted=wasted,
        bps_eff=bps_eff, qcoeffs=qc_win, shift=sh_win, precision=prec_win,
        warmup=warmup, residual=residual, po=po, params=params,
        use_rice2=use_rice2)


def search_and_realize(x, bps_eff, wasted, cfg: EncoderConfig,
                       bank: lpc_ops.ApodizationBank) -> SubframeChoice:
    """Find and realize the cheapest subframe encoding per (frame, channel).

    x:       [B, CH, N] int32 — wasted-bits-shifted candidate signals
             (int64 in the 33-bit side configuration, which takes the
             exact wide fixed and LPC residual paths)
    bps_eff: [B, CH] int32 — subframe bps after wasted-bit reduction
    wasted:  [B, CH] int32

    Its stages are profiler ranges: flac.lpc_coeffs (the windowed
    autocorrelation, window_autocorrelation: K11, then lpc_candidates:
    K6), flac.residuals
    (candidate_residuals: K8), flac.rice (the Rice cost table,
    _rice_cost: K7) and flac.select (the argmin over every candidate and
    the realize, select_and_realize: K9).
    """
    B, CH, N = x.shape
    dev = x.device
    max_po = fmt.max_rice_partition_order_limited(
        cfg.max_residual_partition_order, N, 0)
    O = min(cfg.max_lpc_order, N - 1)

    # ---- LPC candidates: one guessed order per apodization (all orders
    # with -e, mirroring min_lpc_order=1 at stream_encoder.c:4221-4224) ----
    if O > 0:
        with record_function("flac.lpc_coeffs"):
            windows, combine = bank.on(dev)            # [W, N], [A, W] f64
            autoc = lpc_ops.window_autocorrelation(
                x, windows, combine, O)                # [B,CH,A,O+1] f64
            qc, qshift, cand_order, prec, cand_ok = lpc_candidates(
                autoc, bps_eff, N, cfg)
    else:
        qc = torch.zeros((B, CH, 0, fmt.MAX_LPC_ORDER), dtype=torch.int32,
                         device=dev)
        qshift, cand_order, prec = (
            torch.zeros((B, CH, 0), dtype=torch.int32, device=dev)
            for _ in range(3))
        cand_ok = torch.zeros((B, CH, 0), dtype=torch.bool, device=dev)

    with record_function("flac.residuals"):
        res_all, order_all, f_ok, fit_ok = candidate_residuals(
            x, qc, qshift, cand_order, bps_eff, cfg.max_subframe_bps >= 28,
            "i32" if cfg.max_subframe_bps <= 17 else "f64", O)

    # ---- one exact Rice pass over ALL rice-coded candidates ----
    with record_function("flac.rice"):
        r_bits, r_ks, r_rice2 = _rice_cost(res_all, order_all, N, max_po,
                                           cfg)

    with record_function("flac.select"):
        return select_and_realize(x, bps_eff, wasted, res_all, order_all,
                                  f_ok, cand_ok, fit_ok, prec, qc, qshift,
                                  r_bits, r_ks, r_rice2)
