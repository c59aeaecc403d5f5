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
from flac_tpu.ops import lpc as jlpc
from flac_tpu.ops import rice as jrice
from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch.models import stereo, subframe
from flac_tpu_torch.ops import lpc as tlpc
from flac_tpu_torch.ops import lpc_cuda, rice_cost_cuda, search_synth

torch.set_num_threads(1)

LPC_CASES = search_synth.lpc_cases()
RICE_CASES = search_synth.rice_cases()


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
