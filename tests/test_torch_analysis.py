"""flac_tpu_torch's analysis stages against flac_tpu's on the CPU: Rice
costs, fixed predictors, stereo candidates and assignment, and the encode
half of the LPC ops.

Integer stages must be bit-identical.  Float stages are compared with a
stated tolerance: XLA and torch sum float32 products in different orders.
Inputs are made with numpy from fixed seeds and fed to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from flac_tpu import EncoderConfig as JConfig
from flac_tpu.models import stereo as jst
from flac_tpu.ops import fixed as jfx
from flac_tpu.ops import lpc as jlpc
from flac_tpu.ops import rice as jrice
from flac_tpu_torch import EncoderConfig as TConfig
from flac_tpu_torch import convert
from flac_tpu_torch.models import stereo as tst
from flac_tpu_torch.ops import bitops
from flac_tpu_torch.ops import fixed as tfx
from flac_tpu_torch.ops import lpc as tlpc
from flac_tpu_torch.ops import rice as trice

# xdist runs several workers side by side, each with JAX's own threads;
# one torch thread a worker keeps the port's many small CPU ops from
# oversubscribing the cores
torch.set_num_threads(1)


def T(a):
    return convert.tensor_from_reference(np.asarray(a))


def same(jax_out, torch_out):
    j = np.asarray(jax_out)
    j = j.view(np.int64) if j.dtype == np.uint64 else j.astype(np.int64)
    np.testing.assert_array_equal(j, torch_out.numpy().astype(np.int64))


def residuals(rng, shape, bits):
    """int32 residuals of up to `bits` magnitude bits, sign random."""
    mag = rng.integers(0, 1 << bits, shape, dtype=np.int64)
    return (mag * rng.choice([-1, 1], shape)).clip(
        -(1 << 31), (1 << 31) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# bit helpers and Rice
# ---------------------------------------------------------------------------

def test_zigzag():
    rng = np.random.default_rng(0)
    r = residuals(rng, (3, 257), 31)
    r[0, :4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    same(jrice.zigzag(jnp.asarray(r)), trice.zigzag(T(r)))


def test_bit_length_and_reductions():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 1 << 32, (5, 64), dtype=np.int64)
    u[0, :6] = [0, 1, 2, 3, (1 << 31), (1 << 32) - 1]
    same(jrice._bit_length(jnp.asarray(u.astype(np.uint32))),
         bitops.bit_length(T(u)))
    np.testing.assert_array_equal(
        bitops.or_reduce(T(u)).numpy(), np.bitwise_or.reduce(u, axis=-1))
    np.testing.assert_array_equal(
        bitops.xor_reduce(T(u[:, :63])).numpy(),
        np.bitwise_xor.reduce(u[:, :63], axis=-1))
    x = rng.integers(-(1 << 62), 1 << 62, 50, dtype=np.int64)
    s = rng.integers(0, 64, 50)
    np.testing.assert_array_equal(
        bitops.srl64(T(x), T(s)).numpy().view(np.uint64),
        x.view(np.uint64) >> s.astype(np.uint64))


COST_CASES = [  # (bits of residual magnitude, kmax, plen, escape, max_po)
    (8, 14, 4, False, 3),
    (12, 14, 4, True, 4),
    (20, 30, 5, False, 3),
    (31, 30, 5, True, 2),     # folded values above 2^30
    (30, 14, 4, True, 0),
]


@pytest.mark.parametrize("bits,kmax,plen,escape,max_po", COST_CASES)
def test_partition_cost_table(bits, kmax, plen, escape, max_po):
    rng = np.random.default_rng(bits * 7 + max_po)
    N = 256
    r = residuals(rng, (3, 4, N), bits)
    # vary magnitude per partition so different k and escapes win
    r = (r >> rng.integers(0, bits, (3, 4, 1))).astype(np.int32)
    order = rng.integers(0, 9, (3, 4)).astype(np.int32)
    order[0, 0] = N >> max_po                 # invalid at the finest order
    r[np.arange(N)[None, None, :] < order[..., None]] = 0
    ju = jrice.zigzag(jnp.asarray(r))
    tu = trice.zigzag(T(r))
    jb, jk = jrice.partition_cost_table(ju, jnp.asarray(order), N, max_po,
                                        kmax, plen=plen, escape=escape)
    tb, tk = trice.partition_cost_table(tu, T(order), N, max_po, kmax,
                                        plen=plen, escape=escape)
    same(jb, tb)
    same(jk, tk)


def test_partition_cost_table_ties():
    """Residual +-1 folds to 2: k=0, 1 and 2 all cost 3 bits a sample; the
    first (smallest) parameter must win, as in the reference's argmin."""
    N = 64
    r = np.tile(np.array([1, -1], np.int32), (2, N // 2))
    r[1, 32:] = 0                    # second row: ties in one partition
    ju = jrice.zigzag(jnp.asarray(r))
    tu = trice.zigzag(T(r))
    order = np.zeros(2, np.int32)
    jb, jk = jrice.partition_cost_table(ju, jnp.asarray(order), N, 1, 14)
    tb, tk = trice.partition_cost_table(tu, T(order), N, 1, 14)
    same(jb, tb)
    same(jk, tk)
    assert int(tk[0, 0, 0]) == 0


# ---------------------------------------------------------------------------
# fixed predictors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16, 24])
def test_fixed_residuals_all(bits):
    rng = np.random.default_rng(bits)
    x = residuals(rng, (2, 3, 200), bits - 1)
    same(jfx.fixed_residuals_all(jnp.asarray(x)),
         tfx.fixed_residuals_all(T(x)))
    xs = x[..., :3]                          # shorter than the orders
    same(jfx.fixed_residuals_all(jnp.asarray(xs)),
         tfx.fixed_residuals_all(T(xs)))


# ---------------------------------------------------------------------------
# stereo
# ---------------------------------------------------------------------------

def test_wasted_bits():
    rng = np.random.default_rng(2)
    x = residuals(rng, (4, 3, 100), 14)
    x = (x << np.array([0, 1, 5, 13])[:, None, None]).astype(np.int32)
    x[0, 0] = 0                              # all zero: 0 wasted bits
    x[1, 1] = -(1 << 20)                     # constant power of two
    x[2, 2, :] = 0
    x[2, 2, 7] = -(1 << 31)
    same(jst.wasted_bits(jnp.asarray(x)), tst.wasted_bits(T(x)))


@pytest.mark.parametrize("channels,mid_side,bps", [(2, True, 16), (2, False, 8),
                                                   (1, True, 24),
                                                   (6, True, 20)])
def test_build_channel_candidates(channels, mid_side, bps):
    rng = np.random.default_rng(channels * 100 + bps)
    pcm = residuals(rng, (3, channels, 128), bps - 1)
    pcm[0] = (pcm[0] >> 3) << 3              # wasted bits in one frame
    kw = dict(channels=channels, bits_per_sample=bps, do_mid_side=mid_side)
    jx, jb, jw = jst.build_channel_candidates(
        jnp.asarray(pcm), JConfig(**kw).resolve())
    tx, tb, tw = tst.build_channel_candidates(T(pcm), TConfig(**kw).resolve())
    same(jx, tx)
    same(jb, tb)
    same(jw, tw)


def test_loose_assignment():
    rng = np.random.default_rng(3)
    pcm = residuals(rng, (8, 2, 300), 15)
    pcm[:4, 1] = pcm[:4, 0] + rng.integers(-3, 4, (4, 300))  # near mono
    cfg = TConfig.from_preset(1).resolve()
    ja, jc = jst.loose_assignment(jnp.asarray(pcm),
                                  JConfig.from_preset(1).resolve())
    ta, tc = tst.loose_assignment(T(pcm), cfg)
    same(ja, ta)
    same(jc, tc)
    assert set(ta.tolist()) == {0, 3}


def test_select_assignment_ties():
    """Small integer bit counts make many 4-way ties; the first assignment
    must win, as in the reference's argmin."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 4, (200, 4)).astype(np.int32)
    ja, jc = jst.select_assignment(jnp.asarray(bits), None)
    ta, tc = tst.select_assignment(T(bits), None)
    same(ja, ta)
    same(jc, tc)


def test_gather_channels():
    rng = np.random.default_rng(5)
    a = rng.integers(-100, 100, (6, 4, 3, 5)).astype(np.int32)
    b = rng.integers(0, 2, (6, 4)).astype(bool)
    idx = rng.integers(0, 4, (6, 2)).astype(np.int32)
    jo = jst.gather_channels((jnp.asarray(a), jnp.asarray(b)),
                             jnp.asarray(idx))
    to = tst.gather_channels((T(a), T(b)), T(idx))
    same(jo[0], to[0])
    same(jo[1], to[1])
    same(jst.gather_channels(jnp.asarray(a), jnp.asarray(idx)),
         tst.gather_channels(T(a), T(idx)))


# ---------------------------------------------------------------------------
# LPC, encode half
# ---------------------------------------------------------------------------

def windowed_signal(rng, lead, N):
    t = np.arange(N)
    sig = (8000 * np.sin(2 * np.pi * 0.013 * t)
           + 300 * rng.standard_normal(lead + (N,)))
    win = np.hanning(N)
    return (sig * win).astype(np.float32)


@pytest.mark.parametrize("N,max_lag,block", [(1024, 8, 128), (1000, 12, 128),
                                             (300, 6, 1)])
def test_autocorrelation(N, max_lag, block):
    """Within 1e-5 of autoc[0]: the f32 blocked partial sums' error bound
    (flac_tpu/ops/lpc.py:76-79); block=1 is full f64 on both sides."""
    xw = windowed_signal(np.random.default_rng(N), (2, 3), N)
    ja = np.asarray(jlpc.autocorrelation(jnp.asarray(xw), max_lag,
                                         block=block))
    ta = tlpc.autocorrelation(T(xw), max_lag, block=block).numpy()
    assert ta.dtype == np.float64
    tol = 1e-5 if block > 1 else 1e-12
    np.testing.assert_allclose(ta, ja, rtol=0,
                               atol=tol * float(np.abs(ja[..., :1]).max()))
    if N % 128 == 0:
        np.testing.assert_allclose(
            tlpc.autocorrelation_gram(T(xw), max_lag).numpy(),
            np.asarray(jlpc.autocorrelation_mxu(jnp.asarray(xw), max_lag)),
            rtol=0, atol=1e-5 * float(np.abs(ja[..., :1]).max()))


def levinson_inputs(O=12):
    xw = windowed_signal(np.random.default_rng(9), (4,), 2048)
    autoc = np.asarray(jlpc.autocorrelation(jnp.asarray(xw), O, block=1))
    autoc = np.concatenate([autoc, np.zeros((1, O + 1))])    # autoc[0] == 0
    exact = np.zeros((1, O + 1))
    exact[0, :3] = [4.0, 2.0, 1.0]          # an exact low-order fit
    return np.concatenate([autoc, exact])


def test_levinson_all_orders():
    """Given identical autocorrelations: errors within rtol 1e-9, f32
    coefficients within 1e-9 relative (the same f64 recursion, summed in
    another order), validity flags identical."""
    O = 12
    autoc = levinson_inputs(O)
    jc, je, jv = jlpc.levinson_all_orders(jnp.asarray(autoc), O)
    tc, te, tv = tlpc.levinson_all_orders(T(autoc), O)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-9,
                               atol=1e-30)
    same(jv, tv)
    assert not tv[4].any()                  # autoc[0] == 0: nothing valid


def test_estimate_best_order_and_ilog2():
    rng = np.random.default_rng(10)
    errs = np.sort(rng.random((20, 8)) * 1e6, axis=-1)[:, ::-1].copy()
    errs[0, 3:] = 0.0                       # exact fit
    errs[1, 5] = -1.0                       # float-resolution artifact
    overhead = rng.integers(20, 40, 20).astype(np.int32)
    jg, jest = jlpc.estimate_best_order(jnp.asarray(errs), 1024,
                                        jnp.asarray(overhead))
    tg, test_ = tlpc.estimate_best_order(T(errs), 1024, T(overhead))
    same(jg, tg)
    np.testing.assert_allclose(test_.numpy(), np.asarray(jest), rtol=1e-12)
    v = np.arange(1, 33, dtype=np.int32)
    same(jlpc.ilog2(jnp.asarray(v)), tlpc.ilog2(T(v)))


def quantizer_inputs():
    """Float32 coefficients, including exact powers of two (the log2cmax
    boundary) and values whose scaled error lands on .5 (the rounding
    rule: half away from zero)."""
    rng = np.random.default_rng(11)
    A = 40
    c = (rng.standard_normal((A, 32)) * rng.choice([0.01, 0.5, 3.0, 40.0],
                                                   (A, 1))).astype(np.float32)
    orders = rng.integers(1, 33, A).astype(np.int32)
    prec = rng.integers(5, 16, A).astype(np.int32)
    c[0, :4] = [1.0, -0.5, 0.25, 0.125]          # cmax exactly 2^0
    orders[0], prec[0] = 4, 12
    c[1, :3] = [-2.0, 1.0 + 2 ** -11, -0.75]
    orders[1], prec[1] = 3, 12
    # scale 2^(prec-1-0-1) = 2^9: these land on k + 0.5 exactly
    c[2, :4] = [1.0, 0.5 + 0.5 / 512, -0.25 - 0.5 / 512, 1.5 / 512]
    orders[2], prec[2] = 4, 11
    c[3, :] = 0.0                                # cmax == 0: invalid
    c[4, :2] = [1e-9, 3e-9]                       # shift past MAX_SHIFT
    orders[4] = 2
    c[5, :2] = [60000.0, -1.0]                    # negative shift
    orders[5], prec[5] = 2, 5
    c[np.arange(32)[None, :] >= orders[:, None]] = 0
    return c, orders, prec


def test_quantize_coefficients():
    c, orders, prec = quantizer_inputs()
    jq, js, jv = jlpc.quantize_coefficients(jnp.asarray(c),
                                            jnp.asarray(orders),
                                            jnp.asarray(prec))
    tq, ts, tv = tlpc.quantize_coefficients(T(c), T(orders), T(prec))
    same(jq, tq)
    same(js, ts)
    same(jv, tv)
    assert not tv[3] and tv[0]


@pytest.mark.parametrize("mode,bps", [("i32", 16), ("i32", 17),
                                      ("f64", 24)])
def test_lpc_residual(mode, bps):
    rng = np.random.default_rng(bps)
    N, A = 300, 5
    x = residuals(rng, (2, 3, N), bps - 2)
    q = rng.integers(-(1 << 11), 1 << 11, (2, 3, A, 32)).astype(np.int32)
    orders = rng.integers(1, 13, (2, 3, A)).astype(np.int32)
    orders[0, 0, 0] = 32
    q[np.arange(32) >= orders[..., None]] = 0
    shift = rng.integers(0, 16, (2, 3, A)).astype(np.int32)
    bps_eff = np.full((2, 3), bps, np.int32)
    bps_eff[1, 2] = bps - 3
    jr, jok = jlpc.lpc_residual(jnp.asarray(x), jnp.asarray(q),
                                jnp.asarray(shift), jnp.asarray(orders),
                                jnp.asarray(bps_eff), mode)
    tr, tok = tlpc.lpc_residual(T(x), T(q), T(shift), T(orders),
                                T(bps_eff), mode)
    same(jok, tok)
    assert tok.any()
    # an invalid candidate's residual is out of int32 range and never used
    keep = tok.numpy()
    same(np.asarray(jr)[keep], tr[torch.from_numpy(keep)])
