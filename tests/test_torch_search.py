"""The encoder's model search in flac_tpu_torch against flac_tpu, on the CPU:
the plain versions of kernels K6 and K7 (models/subframe.py) on the
corners of ops/search_synth.py.

- lpc_candidates_plain (K6's plain version: Levinson, the order guess or
  every order with -e, the estimate test, the precision or the -p grid,
  the quantizer) against flac_tpu's chain levinson_all_orders ->
  estimate_best_order -> the guessed order's coefficients -> the
  precision clamp -> quantize_coefficients, glued as
  flac_tpu/models/subframe.py:157-218 glues it: the quantized
  coefficients, shifts, orders, precisions and ok flags must be equal
  (integers), but on one named corner: the windowed constant block,
  whose Levinson error falls to the float64 noise of its sums (below
  1e-10 of autoc[0]) within a few orders; its later orders' coefficients
  there depend on the summation order, and are left out (the encoder
  codes such a block CONSTANT whatever its LPC candidates).  The two
  Levinson recursions sum in different orders (the
  port one product at a time, XLA its own way), so their float64 errors
  are held within 1e-9 of themselves (the rtol of
  test_torch_analysis.py::test_levinson_all_orders) or of the block's
  energy autoc[0], whichever is larger (an exact fit's error is a
  cancellation near 0);
- _rice_cost_plain (K7's plain version, on int32 residuals) against
  flac_tpu's zigzag + _rice_cost: equal;
- what K6's design leans on, on the plain version's own ops: one
  Levinson pass to O gives every order's coefficients, errors and
  validity as a pass stopped at that order does (so the kernel picks the
  guessed order's coefficients and runs no second pass), and the
  quantizer writes 0 past the order at every precision of the grid;
- candidate_residuals_plain (K8's plain version: the five fixed orders
  and the LPC candidates' residuals, the masks, the range flags) against
  flac_tpu's fixed_residuals_all and lpc_residual, glued as
  flac_tpu/models/subframe.py:130-146, :224-227 and :240-241 glue them,
  on ops/search_synth.py's residual corners: order_all, f_ok and fit_ok
  equal, and the residual rows equal wherever their flag holds (a wide
  fixed or "f64" row whose flag is false has no defined residuals: each
  package casts out-of-range doubles its own way);
- select_and_realize_plain (K9's plain version) against the reference's
  select and realize (flac_tpu/models/subframe.py:123-128 and :243-299,
  with its _select_c) on the select corners: every integer field of the
  SubframeChoice equal;
- the dispatch: a CPU tensor takes the plain versions, and the kernels'
  wrappers refuse CPU tensors and malformed arguments;
- search_and_realize's profiler ranges.

The kernels themselves run in tests/test_torch_search_cuda.py (card only).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as JConfig
from flac_tpu import format as jfmt
from flac_tpu.models import subframe as jsub
from flac_tpu.ops import fixed as jfixed
from flac_tpu.ops import lpc as jlpc
from flac_tpu.ops import rice as jrice
from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch.models import stereo, subframe
from flac_tpu_torch.ops import lpc as tlpc
from flac_tpu_torch.ops import lpc_cuda, residuals_cuda, rice_cost_cuda, \
    search_synth, select_cuda

torch.set_num_threads(1)

LPC_CASES = search_synth.lpc_cases()
RICE_CASES = search_synth.rice_cases()
RESIDUAL_CASES = search_synth.residual_cases()
SELECT_CASES = search_synth.select_cases()


def _jconfig(cfg: EncoderConfig) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


@functools.partial(jax.jit, static_argnames=("N", "cfg"))
def _reference_candidates(autoc, bps32, N, cfg):
    """flac_tpu's LPC candidate chain, glued as search_and_realize glues it
    (flac_tpu/models/subframe.py:157-218); also the Levinson errors."""
    B, CH, A, O1 = autoc.shape
    O = O1 - 1
    coeffs, errs, order_ok = jlpc.levinson_all_orders(autoc, O)
    if cfg.do_exhaustive_model_search:
        AC = A * O
        cand_coeffs = coeffs.reshape(B, CH, AC, 32)
        cand_order = jnp.broadcast_to(
            jnp.arange(1, O + 1, dtype=jnp.int32), (B, CH, A, O)
        ).reshape(B, CH, AC)
        cand_ok = order_ok.reshape(B, CH, AC)
        ordf = cand_order.astype(jnp.float64)
        errf = errs.reshape(B, CH, AC)
        scale = 0.5 / (N - ordf)
        est = 0.5 * jnp.log2(jnp.where(errf > 0, errf * scale, 1.0))
        est = jnp.where(errf > 0, jnp.maximum(est, 0.0),
                        jnp.where(errf < 0, 1e32, 0.0))
    else:
        AC = A
        guess, est = jlpc.estimate_best_order(
            errs, N, bps32[..., None] + cfg.qlp_coeff_precision)
        onehot = (jnp.arange(O)[None, None, None]
                  == (guess - 1)[..., None]).astype(jnp.float32)
        cand_coeffs = jnp.einsum("bcao,bcaoj->bcaj", onehot, coeffs)
        cand_order = guess
        cand_ok = jnp.take_along_axis(
            order_ok, (guess - 1)[..., None], axis=-1)[..., 0]
    cand_ok = cand_ok & (est < bps32[..., None].astype(jnp.float64))
    if cfg.do_qlp_coeff_prec_search:
        grid = np.arange(jfmt.MIN_QLP_COEFF_PRECISION,
                         jfmt.MAX_QLP_COEFF_PRECISION + 1, dtype=np.int32)
        nP = len(grid)
        clamp = jnp.where(
            bps32[..., None] <= 17,
            jnp.maximum(32 - bps32[..., None] - jlpc.ilog2(cand_order),
                        jfmt.MIN_QLP_COEFF_PRECISION),
            jfmt.MAX_QLP_COEFF_PRECISION)
        ok_p = jnp.asarray(grid) <= clamp[..., None]
        cand_coeffs = jnp.repeat(cand_coeffs, nP, axis=2)
        cand_order = jnp.repeat(cand_order, nP, axis=2)
        cand_ok = (cand_ok[..., None] & ok_p).reshape(B, CH, AC * nP)
        prec = jnp.broadcast_to(jnp.asarray(grid), (B, CH, AC, nP)).reshape(
            B, CH, AC * nP).astype(jnp.int32)
    else:
        static_prec = cfg.qlp_coeff_precision
        prec = jnp.where(
            bps32[..., None] <= 17,
            jnp.minimum(static_prec,
                        32 - bps32[..., None] - jlpc.ilog2(cand_order)),
            static_prec).astype(jnp.int32)
    qc, qshift, q_ok = jlpc.quantize_coefficients(cand_coeffs, cand_order,
                                                  prec)
    return (qc, qshift, cand_order, prec, cand_ok & q_ok), errs


def _lost_precision(case, errs, order):
    """[B, CH, AC] bool: candidates of the windowed constant block (the
    corner in row 3 of search_synth.lpc_batch's first frames) whose order
    comes after an error below 1e-10 of the block's energy autoc[0]: the
    float64 noise of the recursion's sums, where the two summation orders
    give other coefficients."""
    autoc = case["autoc"]
    B, CH, A, _ = autoc.shape
    AC = order.shape[-1]
    a = np.arange(AC) // (AC // A)                     # each one's window
    o = order.clip(min=2) - 2                          # the order before
    with np.errstate(divide="ignore", invalid="ignore"):   # silence
        rel = (np.take_along_axis(errs[:, :, a], o[..., None], -1)[..., 0]
               / autoc[:, :, a, 0])
    corner = (np.arange(B)[:, None] * CH + np.arange(CH)[None, :]) == 3
    return corner[..., None] & (order >= 2) & (np.abs(rel) < 1e-10)


@pytest.mark.parametrize("label,case", LPC_CASES,
                         ids=[c[0] for c in LPC_CASES])
def test_lpc_candidates_plain_matches_flac_tpu(label, case):
    autoc, bps, N, cfg = search_synth.as_lpc_inputs(case, "cpu")
    got = [t.numpy() for t in subframe.lpc_candidates_plain(autoc, bps, N,
                                                            cfg)]
    want, jerrs = _reference_candidates(
        jnp.asarray(case["autoc"]), jnp.asarray(case["bps_eff"]), N,
        _jconfig(cfg))
    want = [np.asarray(w) for w in want]
    # the errors within 1e-9 of themselves or of the block's energy
    # autoc[0], whichever is larger: an exact fit's error is the
    # cancellation 1 - r * r, near 0 in both
    _, terrs, _ = tlpc.levinson_all_orders(autoc, autoc.shape[-1] - 1)
    jerrs = np.asarray(jerrs)
    bound = 1e-9 * np.maximum(np.abs(jerrs), case["autoc"][..., :1])
    assert (np.abs(terrs.numpy() - jerrs) <= bound).all()
    # every output equal, but for the named corner past its precision
    np.testing.assert_array_equal(got[2], want[2], "order")
    keep = ~_lost_precision(case, jerrs, want[2])
    for name, g, w in zip(("qc", "qshift", "prec", "ok"),
                          got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(g[keep], w[keep], name)
    # the corners: silence gives no candidate, the negative error fails
    # the estimate
    ok = got[4].reshape(-1, got[4].shape[-1])
    assert not ok[0].any() and not ok[2].any()


@pytest.mark.parametrize("label,case", RICE_CASES,
                         ids=[c[0] for c in RICE_CASES])
def test_rice_cost_plain_matches_flac_tpu(label, case):
    res, order, N, max_po, cfg = search_synth.as_rice_inputs(case, "cpu")
    got = subframe._rice_cost_plain(res, order, N, max_po, cfg)
    jcfg = _jconfig(cfg)
    want = jax.jit(lambda r, o: jsub._rice_cost(jrice.zigzag(r), o, N,
                                                max_po, jcfg))(
        jnp.asarray(case["res"]), jnp.asarray(case["order"]))
    for name, g, w in zip(("bits", "params", "rice2"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("label,case", LPC_CASES,
                         ids=[c[0] for c in LPC_CASES])
def test_one_levinson_pass_keeps_every_order(label, case):
    """A pass to O gives order o's coefficients, error and validity as a
    pass stopped at o does, bit for bit: K6's single recursion."""
    autoc = torch.from_numpy(case["autoc"])
    O = autoc.shape[-1] - 1
    coeffs, errs, valid = tlpc.levinson_all_orders(autoc, O)
    for o in range(1, O + 1):
        c2, e2, v2 = tlpc.levinson_all_orders(autoc[..., :o + 1], o)
        assert torch.equal(coeffs[..., o - 1, :], c2[..., o - 1, :]), o
        assert torch.equal(errs[..., o - 1], e2[..., o - 1]), o
        assert torch.equal(valid[..., o - 1], v2[..., o - 1]), o


@pytest.mark.parametrize("prec", range(jfmt.MIN_QLP_COEFF_PRECISION,
                                       jfmt.MAX_QLP_COEFF_PRECISION + 1))
def test_quantizer_writes_zero_past_the_order(prec):
    """quantize_coefficients' q past a candidate's order is 0 clamped to
    [qmin, qmax]: 0 at every precision of the grid (K6 writes that tail
    without running the steps)."""
    rng = np.random.default_rng(prec)
    n = 64
    orders = torch.from_numpy(rng.integers(1, 33, n).astype(np.int32))
    c = rng.standard_normal((n, 32)) * 10.0 ** rng.uniform(-3, 2, (n, 1))
    c[np.arange(32)[None, :] >= orders.numpy()[:, None]] = 0.0
    qc, _, _ = tlpc.quantize_coefficients(
        torch.from_numpy(c.astype(np.float32)), orders,
        torch.full((n,), prec, dtype=torch.int32))
    past = torch.arange(32)[None, :] >= orders[:, None]
    assert past.any() and (qc[past] == 0).all()


def test_k6_dispatch_mirrors_the_source():
    """lpc_cuda.lanes, template_order and ctas follow the source's
    constants and dispatch."""
    from pathlib import Path
    src = (Path(lpc_cuda.__file__).parents[1] / "csrc"
           / "lpc_coeffs.cu").read_text()
    assert "return ot <= 8 ? 8 : ot <= 16 ? 16 : 32;" in src
    assert f"constexpr int CTA = {lpc_cuda.CTA};" in src
    for t in lpc_cuda.TEMPLATE_ORDERS[:-1]:
        assert f"if (O <= {t}) return launch<{t}>(a, s);" in src
    assert f"return launch<{lpc_cuda.TEMPLATE_ORDERS[-1]}>(a, s);" in src
    got = {O: (lpc_cuda.template_order(O), lpc_cuda.lanes(O))
           for O in (1, 6, 7, 8, 9, 12, 13, 32)}
    assert got == {1: (6, 8), 6: (6, 8), 7: (8, 8), 8: (8, 8),
                   9: (12, 16), 12: (12, 16), 13: (32, 32), 32: (32, 32)}
    assert lpc_cuda.ctas(256, 8) == 64 and lpc_cuda.ctas(2304, 12) == 1152


def test_dispatch_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors lpc_candidates and _rice_cost are their plain
    versions and never reach a kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")
    monkeypatch.setattr(lpc_cuda, "lpc_candidates", refuse)
    monkeypatch.setattr(rice_cost_cuda, "rice_cost", refuse)
    _, case = LPC_CASES[2]
    args = search_synth.as_lpc_inputs(case, "cpu")
    for a, b in zip(subframe.lpc_candidates(*args),
                    subframe.lpc_candidates_plain(*args)):
        assert torch.equal(a, b)
    _, case = RICE_CASES[7]
    args = search_synth.as_rice_inputs(case, "cpu")
    for a, b in zip(subframe._rice_cost(*args),
                    subframe._rice_cost_plain(*args)):
        assert torch.equal(a, b)
    assert lpc_cuda.launches == 0 and rice_cost_cuda.launches == 0


def test_wrappers_refuse_cpu_tensors_and_bad_arguments():
    autoc, bps, N, cfg = search_synth.as_lpc_inputs(LPC_CASES[0][1], "cpu")
    with pytest.raises(ValueError, match="not on a GPU"):
        lpc_cuda.lpc_candidates(autoc, bps, N, cfg)
    lpc_cuda.check_arguments(autoc, bps, N)
    for bad in (lambda: lpc_cuda.check_arguments(autoc.float(), bps, N),
                lambda: lpc_cuda.check_arguments(autoc, bps.long(), N),
                lambda: lpc_cuda.check_arguments(autoc, bps[:1], N),
                lambda: lpc_cuda.check_arguments(autoc, bps, 8),
                lambda: lpc_cuda.check_arguments(autoc[..., :1], bps, N)):
        with pytest.raises(ValueError):
            bad()
    res, order, N, max_po, cfg = search_synth.as_rice_inputs(
        RICE_CASES[0][1], "cpu")
    with pytest.raises(ValueError, match="not on a GPU"):
        rice_cost_cuda.rice_cost(res, order, N, max_po, cfg)
    rice_cost_cuda.check_arguments(res, order, N, max_po)
    for bad in (lambda: rice_cost_cuda.check_arguments(res.long(), order, N,
                                                       max_po),
                lambda: rice_cost_cuda.check_arguments(res, order.long(), N,
                                                       max_po),
                lambda: rice_cost_cuda.check_arguments(res, order[..., :1],
                                                       N, max_po),
                lambda: rice_cost_cuda.check_arguments(res, order, N, 13),
                lambda: rice_cost_cuda.check_arguments(res, order, N, 16),
                lambda: rice_cost_cuda.check_arguments(
                    res[..., :96], order, 96, 6)):
        with pytest.raises(ValueError):
            bad()


def test_candidate_counts():
    """AC, the LPC candidates a channel: A, times O with -e, times the 11
    precisions with -p, as the plain version lays them out."""
    for label, case in LPC_CASES:
        autoc, bps, N, cfg = search_synth.as_lpc_inputs(case, "cpu")
        A, O = autoc.shape[2], autoc.shape[3] - 1
        qc = subframe.lpc_candidates_plain(autoc, bps, N, cfg)[0]
        assert qc.shape[2] == lpc_cuda.candidates(A, O, cfg), label
        ops = lpc_cuda.chain_ops(O, O)
        assert ops["div"] == O and ops["floor"] == O and ops["log2"] == 1
        assert ops["add"] > O * (O + 1) // 2 + 6 * O


def test_search_ranges():
    """search_and_realize marks flac.lpc_coeffs, flac.residuals, flac.rice
    and flac.select, once a call each, inside one another's order."""
    from torch.profiler import ProfilerActivity, profile
    cfg = EncoderConfig.from_preset(5, blocksize=256).resolve()
    pcm = signals.make_test_signal(4 * 256, seed=3)
    x_in = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, 4, 256).transpose(1, 0, 2)))
    x, bps, wasted = stereo.build_channel_candidates(x_in, cfg)
    bank = tlpc.build_apodization_bank(256, cfg.apodizations)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        subframe.search_and_realize(x, bps, wasted, cfg, bank)
    names = [e.name for e in prof.events() if e.name.startswith("flac.")]
    assert names == ["flac.lpc_coeffs", "flac.residuals", "flac.rice",
                     "flac.select"]


@functools.partial(jax.jit, static_argnames=("fixed_wide", "lpc_mode"))
def _reference_residuals(x, qc, qshift, cand_order, bps32, fixed_wide,
                         lpc_mode):
    """flac_tpu's fixed and LPC residuals, glued as search_and_realize
    glues them (flac_tpu/models/subframe.py:130-146, :224-227,
    :240-241)."""
    B, CH, N = x.shape
    n_idx = jnp.arange(N, dtype=jnp.int32)
    forder = jnp.arange(5, dtype=jnp.int32)
    fmask = n_idx[None, :] >= forder[:, None]
    if fixed_wide:
        fres_w = jfixed.fixed_residuals_all(x.astype(jnp.float64))
        fres_w = jnp.where(fmask, fres_w, 0)
        f_ok = jnp.max(jnp.abs(fres_w), axis=-1) < jnp.float64(2 ** 31)
        fres = fres_w.astype(jnp.int32)
    else:
        fres = jnp.where(fmask, jfixed.fixed_residuals_all(x), 0)
        f_ok = jnp.ones(fres.shape[:-1], bool)
    forder_b = jnp.broadcast_to(forder, (B, CH, 5)).astype(jnp.int32)
    if qc.shape[2]:
        res_lpc, fit_ok = jlpc.lpc_residual(x, qc, qshift, cand_order,
                                            bps32, lpc_mode)
    else:
        res_lpc = jnp.zeros((B, CH, 0, N), jnp.int32)
        fit_ok = jnp.zeros((B, CH, 0), bool)
    res_all = jnp.concatenate([fres, res_lpc], axis=2)
    order_all = jnp.concatenate([forder_b, cand_order], axis=2)
    return res_all, order_all, f_ok, fit_ok


@pytest.mark.parametrize("label,case", RESIDUAL_CASES,
                         ids=[c[0] for c in RESIDUAL_CASES])
def test_candidate_residuals_plain_matches_flac_tpu(label, case):
    args = search_synth.as_residual_inputs(case, "cpu")
    got = subframe.candidate_residuals_plain(*args)
    want = _reference_residuals(
        *(jnp.asarray(case[k]) for k in ("x", "qc", "qshift", "cand_order",
                                         "bps_eff")),
        fixed_wide=case["fixed_wide"], lpc_mode=case["lpc_mode"])
    want = [np.asarray(w) for w in want]
    for name, g, w in zip(("order_all", "f_ok", "fit_ok"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(g.numpy(), w, name)
    # the residual rows wherever their flag holds: every narrow fixed and
    # "i32" row (those wrap alike), a wide fixed or "f64" row where it
    # is valid
    rows = residuals_cuda.comparable_rows(got[2], got[3], case["fixed_wide"],
                                          case["lpc_mode"]).numpy()
    np.testing.assert_array_equal(got[0].numpy()[rows], want[0][rows],
                                  "res_all")
    assert got[0].shape == want[0].shape


@jax.jit
def _reference_select(x, bps32, wasted, res_all, order_all, f_ok, cand_ok,
                      fit_ok, prec, qc, qshift, r_bits, r_ks, r_rice2):
    """The reference's select and realize, as search_and_realize runs it
    (flac_tpu/models/subframe.py:123-128 and :243-299)."""
    B, CH, N = x.shape
    AC = qc.shape[2]
    C_rice = 5 + AC
    overhead = 8 + wasted
    verb_bits = overhead + N * bps32
    is_const = jnp.all(x == x[..., :1], axis=-1)
    const_bits = jnp.where(is_const, overhead + bps32, jsub.BIG)
    forder = jnp.arange(5, dtype=jnp.int32)
    rice_best = jnp.min(r_bits, axis=-1)
    po_all = jnp.argmin(r_bits, axis=-1).astype(jnp.int32)
    fixed_hdr = overhead[..., None] + forder * bps32[..., None]
    if AC:
        lpc_hdr = (overhead[..., None] + 4 + 5
                   + order_all[:, :, 5:] * (prec + bps32[..., None]))
        hdr_all = jnp.concatenate([fixed_hdr, lpc_hdr], axis=2)
        ok_all = jnp.concatenate([f_ok & (forder < N), cand_ok & fit_ok],
                                 axis=2)
    else:
        hdr_all = fixed_hdr
        ok_all = f_ok & (forder < N)
    total_all = jnp.where(ok_all & (rice_best < jsub.BIG),
                          hdr_all + jnp.minimum(rice_best, jsub.BIG),
                          jsub.BIG)
    allbits = jnp.concatenate(
        [verb_bits[..., None], const_bits[..., None], total_all], axis=-1)
    win = jnp.argmin(allbits, axis=-1).astype(jnp.int32)
    best_bits = jnp.min(allbits, axis=-1)
    is_verb, is_constw = win == 0, win == 1
    is_fixed, is_lpc = (win >= 2) & (win < 7), win >= 7
    win_c = jnp.clip(win - 2, 0, C_rice - 1)
    type_ = jnp.where(is_verb, jfmt.SUBFRAME_TYPE_VERBATIM,
                      jnp.where(is_constw, jfmt.SUBFRAME_TYPE_CONSTANT,
                                jnp.where(is_fixed, jfmt.SUBFRAME_TYPE_FIXED,
                                          jfmt.SUBFRAME_TYPE_LPC))
                      ).astype(jnp.int32)
    has_res = is_fixed | is_lpc
    order = jnp.where(has_res, jsub._select_c(order_all, win_c, C_rice), 0)
    residual = jnp.where(has_res[..., None],
                         jsub._select_c(res_all, win_c, C_rice), 0)
    po = jnp.where(has_res, jsub._select_c(po_all, win_c, C_rice), 0)
    ks_sel = jsub._select_c(r_ks, win_c, C_rice)
    params = jnp.take_along_axis(ks_sel, po[..., None, None],
                                 axis=-2)[..., 0, :]
    r2_sel = jsub._select_c(r_rice2, win_c, C_rice)
    use_rice2 = jnp.take_along_axis(r2_sel, po[..., None], -1)[..., 0]
    if AC:
        lidx = jnp.clip(win - 7, 0, AC - 1)
        qc_win = jnp.where(is_lpc[..., None], jsub._select_c(qc, lidx, AC),
                           0)
        sh_win = jnp.where(is_lpc, jsub._select_c(qshift, lidx, AC), 0)
        prec_win = jnp.where(is_lpc, jsub._select_c(prec, lidx, AC), 0)
    else:
        qc_win = jnp.zeros((B, CH, 32), jnp.int32)
        sh_win = jnp.zeros((B, CH), jnp.int32)
        prec_win = jnp.zeros((B, CH), jnp.int32)
    warmup = x[..., :32] if N >= 32 else \
        jnp.pad(x, [(0, 0), (0, 0), (0, 32 - N)])
    return {"bits": best_bits, "type_": type_, "order": order,
            "qcoeffs": qc_win, "shift": sh_win, "precision": prec_win,
            "warmup": warmup, "residual": residual, "po": po,
            "params": params, "use_rice2": use_rice2}


@pytest.mark.parametrize("label,case", SELECT_CASES,
                         ids=[c[0] for c in SELECT_CASES])
def test_select_and_realize_plain_matches_flac_tpu(label, case):
    args = search_synth.as_select_inputs(case, "cpu")
    got = subframe.select_and_realize_plain(*args)
    want = _reference_select(*(jnp.asarray(case[k])
                               for k in search_synth.SELECT_KEYS))
    assert set(want) == set(select_cuda.OUTPUTS)
    for name in select_cuda.OUTPUTS:
        g = getattr(got, name).numpy()
        w = np.asarray(want[name])
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)
    assert got.wasted is args[2] and got.bps_eff is args[1]


def test_select_corners_reach_every_winner():
    """The select corners make each kind of winner, and their ties go to
    the first index: verbatim over an equal fixed order, a fixed order
    over an equal LPC candidate, the first of two equal LPC candidates;
    every table has equal partition-order bits somewhere."""
    kinds = set()
    for label, case in SELECT_CASES:
        ch = subframe.select_and_realize_plain(
            *search_synth.as_select_inputs(case, "cpu"))
        kinds |= set(ch.type_.flatten().tolist())
        R = ch.type_.numel()
        rows = np.arange(R) % 6
        t = ch.type_.reshape(-1).numpy()
        assert (t[rows == 1] == jfmt.SUBFRAME_TYPE_CONSTANT).all(), label
        assert (t[rows == 2] == jfmt.SUBFRAME_TYPE_VERBATIM).all(), label
        assert (t[rows == 5] == jfmt.SUBFRAME_TYPE_VERBATIM).all(), label
        AC = case["qc"].shape[2]
        if AC >= 1:
            # the LPC candidate that ties fixed order 2 never wins
            assert (t[rows == 4] != jfmt.SUBFRAME_TYPE_LPC).all(), label
        if AC >= 2:
            # of two equal LPC candidates the first wins: its coefficients
            lpc = (rows == 3) & (t == jfmt.SUBFRAME_TYPE_LPC)
            qc0 = case["qc"].reshape(R, AC, 32)[:, 0]
            assert (ch.qcoeffs.reshape(R, 32).numpy()[lpc] == qc0[lpc]).all()
        # equal partition-order bits in every table
        rb = case["r_bits"].reshape(R, 5 + AC, -1)
        if rb.shape[-1] > 1:
            assert ((rb == rb.min(-1, keepdims=True)).sum(-1) > 1).any()
    assert kinds == {0, 1, 2, 3}


def test_residual_corners_reach_every_flag():
    """The residual corners hold "i32" rows whose range analysis fails,
    wide fixed and "f64" rows past 2^31 (flags false) and rows within it,
    orders 1-32 and shifts 0 and 15."""
    seen = {"fit_false_i32": False, "fit_false_f64": False,
            "fit_true_f64": False, "f_false": False, "f_true_wide": False}
    orders, shifts = set(), set()
    for label, case in RESIDUAL_CASES:
        _, _, f_ok, fit_ok = subframe.candidate_residuals_plain(
            *search_synth.as_residual_inputs(case, "cpu"))
        if case["lpc_mode"] == "i32":
            seen["fit_false_i32"] |= bool((~fit_ok).any())
        else:
            seen["fit_false_f64"] |= bool((~fit_ok).any())
            seen["fit_true_f64"] |= bool(fit_ok.any())
        if case["fixed_wide"]:
            seen["f_false"] |= bool((~f_ok).any())
            seen["f_true_wide"] |= bool(f_ok.any())
        orders |= set(case["cand_order"].reshape(-1).tolist())
        shifts |= set(case["qshift"].reshape(-1).tolist())
        # the quantizer's contract: zero past each candidate's order
        past = (np.arange(32)[None, None, None, :]
                >= case["cand_order"][..., None])
        assert (case["qc"][past] == 0).all(), label
    assert all(seen.values()), seen
    assert set(range(1, 33)) <= orders and {0, 15} <= shifts


def test_quantizer_shifts_are_in_k8s_range():
    """K8 shifts its predictions right by the quantizer's shift; the
    quantizer clamps it to 0..15 (ops/lpc.py quantize_coefficients), so a
    right shift by it is the plain version's floor division."""
    for label, case in LPC_CASES:
        qshift = subframe.lpc_candidates_plain(
            *search_synth.as_lpc_inputs(case, "cpu"))[1]
        assert int(qshift.min()) >= 0 and int(qshift.max()) <= 15, label


def test_k8_k9_dispatch_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors candidate_residuals and select_and_realize are their
    plain versions and never reach a kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")
    monkeypatch.setattr(residuals_cuda, "candidate_residuals", refuse)
    monkeypatch.setattr(select_cuda, "select_and_realize", refuse)
    args = search_synth.as_residual_inputs(RESIDUAL_CASES[1][1], "cpu")
    for a, b in zip(subframe.candidate_residuals(*args),
                    subframe.candidate_residuals_plain(*args)):
        assert torch.equal(a, b)
    args = search_synth.as_select_inputs(SELECT_CASES[1][1], "cpu")
    for a, b in zip(subframe.select_and_realize(*args),
                    subframe.select_and_realize_plain(*args)):
        assert torch.equal(a, b)
    assert residuals_cuda.launches == 0 and select_cuda.launches == 0


def test_k8_k9_wrappers_refuse_cpu_tensors_and_bad_arguments():
    args = search_synth.as_residual_inputs(RESIDUAL_CASES[1][1], "cpu")
    with pytest.raises(ValueError, match="not on a GPU"):
        residuals_cuda.candidate_residuals(*args)
    residuals_cuda.check_arguments(*args)
    x, qc, qshift, order, bps, wide, mode, mo = args
    for bad in ((x.float(), qc, qshift, order, bps, wide, mode, mo),
                (x.long(), qc, qshift, order, bps, wide, mode, mo),
                (x, qc[..., :8], qshift, order, bps, wide, mode, mo),
                (x, qc, qshift.long(), order, bps, wide, mode, mo),
                (x, qc, qshift, order[..., :1], bps, wide, mode, mo),
                (x, qc, qshift, order, bps[:1], wide, mode, mo),
                (x, qc, qshift, order, bps, wide, "f32", mo),
                (x, qc, qshift, order, bps, wide, mode, 33),
                (x[..., :0], qc, qshift, order, bps, wide, mode, mo)):
        with pytest.raises(ValueError):
            residuals_cuda.check_arguments(*bad)
    args = search_synth.as_select_inputs(SELECT_CASES[1][1], "cpu")
    with pytest.raises(ValueError, match="not on a GPU"):
        select_cuda.select_and_realize(*args)
    select_cuda.check_arguments(*args)
    for i, t in enumerate(args):
        wrong = t.to(torch.int16) if t.dtype != torch.int16 else t.int()
        bad = args[:i] + (wrong,) + args[i + 1:]
        with pytest.raises(ValueError):
            select_cuda.check_arguments(*bad)
        if t.ndim >= 3:
            bad = args[:i] + (t[:, :, :1],) + args[i + 1:]
            with pytest.raises(ValueError):
                select_cuda.check_arguments(*bad)


def test_k8_layout_mirrors_the_source():
    """residuals_cuda's grid and tap bound follow the source's constants:
    up to CLUSTER CTAs a row, halved while the rows would pass one wave of
    the card's slots, each a run of spans of SPAN samples (never none),
    the coefficient tables of BLOCK candidates, a ring of RING spans;
    the taps stopping at lpc_residual's max_j."""
    from pathlib import Path
    src = (Path(residuals_cuda.__file__).parents[1] / "csrc"
           / "candidate_residuals.cu").read_text()
    for name, value in (("THREADS", residuals_cuda.THREADS),
                        ("RING", residuals_cuda.RING),
                        ("CLUSTER", residuals_cuda.CLUSTER),
                        ("BLOCK", residuals_cuda.BLOCK),
                        ("FIXED", residuals_cuda.FIXED_ORDERS),
                        ("HALO", jfmt.MAX_LPC_ORDER)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int SPAN = THREADS * PER_THREAD;" in src
    assert residuals_cuda.SPAN == residuals_cuda.THREADS * 4
    # 64 frames of stereo (256 rows of 4096) on 132 SMs: 2 CTAs a row of
    # 4 spans each at 4 or 6 CTAs an SM; 5.1's 384 rows a CTA a row;
    # mono's 64 rows 8 CTAs a row of one span
    assert residuals_cuda.ctas(256, 4096, 132 * 4) == (2, 4)
    assert residuals_cuda.ctas(256, 4096, 132 * 6) == (2, 4)
    assert residuals_cuda.ctas(384, 4096, 132 * 4) == (1, 8)
    assert residuals_cuda.ctas(64, 4096, 132 * 6) == (8, 1)
    # never a CTA without a span: 9 spans over 8 CTAs is 5 of 2
    assert residuals_cuda.ctas(2, 4097, 132 * 4) == (5, 2)
    assert residuals_cuda.ctas(2, 4608, 132 * 4) == (5, 2)
    assert residuals_cuda.ctas(4, 1152, 132 * 4) == (3, 1)
    assert residuals_cuda.ctas(4, 16, 132 * 4) == (1, 1)
    assert residuals_cuda.ctas(2, 32768, 132 * 4) == (8, 8)
    for rows, N, slots in ((256, 4096, 528), (2, 4097, 528), (300, 1000, 7),
                           (1, 513, 1), (5000, 32768, 792)):
        parts, per = residuals_cuda.ctas(rows, N, slots)
        spans = -(-N // residuals_cuda.SPAN)
        assert 1 <= parts <= residuals_cuda.CLUSTER
        assert (parts - 1) * per < spans <= parts * per
    assert [residuals_cuda.max_taps(N, o) for N, o in
            ((4096, 8), (33, 32), (16, 32), (2, 0), (4096, 0))] \
        == [8, 32, 15, 1, 1]
