"""flac_tpu_torch's bit packer, CRCs and kernel K1's plain version, held
bit-identical to flac_tpu's on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX Pallas deposit (`pack_pallas.pack_fields64_mxu`) runs in interpret
mode, as tests/test_pack_pallas.py runs it.  The CUDA kernel itself needs a
GPU: test_torch_pack_cuda.py holds it against its plain version there.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from flac_tpu.ops import bitpack as jbp
from flac_tpu.ops import crc as jcrc
from flac_tpu_torch import convert
from flac_tpu_torch.ops import bitpack as tbp
from flac_tpu_torch.ops import crc as tcrc
from flac_tpu_torch.ops import pack_cuda

# xdist runs several workers side by side, each with JAX's own threads;
# one torch thread a worker keeps the port's many small CPU ops from
# oversubscribing the cores
torch.set_num_threads(1)


def T(a):
    """numpy -> the port's tensor (uint32 widened, uint64 reinterpreted)."""
    return convert.tensor_from_reference(np.asarray(a))


def same(jax_out, torch_out):
    """Bit-identical after both are read as int64 numpy arrays."""
    j = np.asarray(jax_out)
    j = j.view(np.int64) if j.dtype == np.uint64 else j.astype(np.int64)
    np.testing.assert_array_equal(j, torch_out.numpy().astype(np.int64))


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    monkeypatch.setattr(pl, "pallas_call", patched)


# ---------------------------------------------------------------------------
# field lists
# ---------------------------------------------------------------------------

def fields64(rng, B, S, max_pb=60):
    """The random 64-bit field lists of tests/test_pack_pallas.py."""
    pbits = rng.integers(0, max_pb + 1, (B, S))
    pbits[rng.random((B, S)) < 0.08] = 0
    nzeros = rng.integers(0, 4, (B, S))
    pay = rng.integers(0, 1 << 62, (B, S), dtype=np.int64).astype(np.uint64)
    pay &= (np.uint64(1) << pbits.astype(np.uint64)) - np.uint64(1)
    return nzeros.astype(np.int32), pay, pbits.astype(np.int32)


def fields32(rng, B, S):
    pbits = rng.integers(0, 33, (B, S))
    pbits[rng.random((B, S)) < 0.1] = 0
    nzeros = rng.integers(0, 6, (B, S))
    pay = rng.integers(0, 1 << 32, (B, S), dtype=np.int64)
    pay &= (np.int64(1) << pbits) - 1
    return (nzeros.astype(np.int32), pay.astype(np.uint32),
            pbits.astype(np.int32))


def dense_small_fields():
    rng = np.random.default_rng(7)
    pbits = rng.integers(1, 5, (8, 1024)).astype(np.int32)
    pay = rng.integers(0, 16, (8, 1024)).astype(np.uint64)
    pay &= (np.uint64(1) << pbits.astype(np.uint64)) - np.uint64(1)
    return np.zeros((8, 1024), np.int32), pay, pbits


PALLAS_CASES = [(8, 640, 2048), (3, 130, 1024), (16, 352, 4096)]


@pytest.mark.parametrize("B,S,W", PALLAS_CASES)
def test_k1_plain_matches_scatter_and_pallas(B, S, W, interpret_pallas):
    from flac_tpu.ops import pack_pallas
    nz, pay, pb = fields64(np.random.default_rng(B * 1000 + S), B, S)
    rw, rt = jbp.pack_fields64(jnp.asarray(nz), jnp.asarray(pay),
                               jnp.asarray(pb), W)
    gw, gt = pack_pallas.pack_fields64_mxu(jnp.asarray(nz), jnp.asarray(pay),
                                           jnp.asarray(pb), W)
    tw, tt = tbp.pack_fields64(T(nz), T(pay), T(pb), W)
    same(rw, tw)
    same(gw, tw)
    same(rt, tt)
    same(gt, tt)


def test_k1_plain_dense_small_fields(interpret_pallas):
    from flac_tpu.ops import pack_pallas
    nz, pay, pb = dense_small_fields()
    gw, _ = pack_pallas.pack_fields64_mxu(jnp.asarray(nz), jnp.asarray(pay),
                                          jnp.asarray(pb), 1024)
    tw, _ = tbp.pack_fields64(T(nz), T(pay), T(pb), 1024)
    same(gw, tw)


def edge_cases64():
    """63-bit fields, fields straddling three words, fields past W, and a
    negative word index (dropped after one wrap by the reference)."""
    rng = np.random.default_rng(63)
    out = []
    pb = np.full((4, 500), 63, np.int32)
    pay = rng.integers(0, 1 << 63, (4, 500), dtype=np.int64)
    out.append(("63-bit", rng.integers(0, 3, (4, 500)).astype(np.int32),
                pay, pb, 2048))
    nz = rng.integers(1, 32, (4, 300)).astype(np.int32)
    pb = rng.integers(58, 64, (4, 300)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (4, 300), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    out.append(("straddle", nz, pay, pb, 1024))
    pb = np.full((2, 100), 40, np.int32)
    pay = rng.integers(0, 1 << 40, (2, 100), dtype=np.int64)
    out.append(("past-W", np.zeros((2, 100), np.int32), pay, pb, 64))
    nz = np.zeros((2, 40), np.int32)
    nz[:, 0] = -200                       # positions start below zero
    pb = np.full((2, 40), 20, np.int32)
    pay = rng.integers(0, 1 << 20, (2, 40), dtype=np.int64)
    out.append(("negative", nz, pay, pb, 64))
    return out


@pytest.mark.parametrize("case", edge_cases64(), ids=lambda c: c[0])
def test_k1_plain_edge_cases(case):
    _, nz, pay, pb, W = case
    rw, rt = jbp.pack_fields64(jnp.asarray(nz), jnp.asarray(pay.view(
        np.uint64)), jnp.asarray(pb), W)
    tw, tt = pack_cuda.pack_fields64(T(nz), T(pay), T(pb), W)
    same(rw, tw)
    same(rt, tt)


def test_k1_wrapper_dispatch_on_cpu():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing."""
    nz, pay, pb = fields64(np.random.default_rng(3), 4, 200)
    before = pack_cuda.launches
    kw, kt = pack_cuda.pack_fields64(T(nz), T(pay), T(pb), 1024)
    pw, pt = tbp.pack_fields64(T(nz), T(pay), T(pb), 1024)
    assert torch.equal(kw, pw) and torch.equal(kt, pt)
    assert pack_cuda.launches == before
    with pytest.raises(ValueError):
        pack_cuda.pack_fields64_cuda(T(nz), T(pay), T(pb), 1024)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_fields_and_prefix_cross_check(seed):
    B, S, W = 4, 300, 512
    nz, pay, pb = fields32(np.random.default_rng(seed), B, S)
    rw, rt = jbp.pack_fields(jnp.asarray(nz), jnp.asarray(pay),
                             jnp.asarray(pb), W)
    tw, tt = tbp.pack_fields(T(nz), T(pay), T(pb), W)
    same(rw, tw)
    same(rt, tt)
    # the reference's prefix-difference formulation, recast in torch
    same(jbp.pack_fields_prefix(jnp.asarray(nz), jnp.asarray(pay),
                                jnp.asarray(pb), W)[0], tw)
    same(np.asarray(pack_fields_prefix(T(nz), T(pay), T(pb), W)), tw)


def pack_fields_prefix(nzeros, payload, pbits, max_words):
    """bitpack.pack_fields_prefix of the reference in torch: prefix-sum the
    contributions in field order and difference them at each word's field
    boundaries (found by binary search); wrapping sums are exact because
    each word's bits are disjoint."""
    w, hi, lo, _ = tbp._field_word_contribs(nzeros, payload, pbits)
    zero = torch.zeros((w.shape[0], 1), dtype=torch.int64)
    Phi = torch.cat([zero, torch.cumsum(hi, dim=1)], dim=1)
    Plo = torch.cat([zero, torch.cumsum(lo, dim=1)], dim=1)
    q = torch.arange(max_words, dtype=torch.int32).expand(w.shape[0], -1)
    e = torch.searchsorted(w.contiguous(), q.contiguous(), right=True)
    e1 = torch.nn.functional.pad(e[:, :-1], (1, 0))
    e2 = torch.nn.functional.pad(e[:, :-2], (2, 0))
    words = (Phi.gather(1, e) - Phi.gather(1, e1)
             + Plo.gather(1, e1) - Plo.gather(1, e2))
    return words & tbp.U32


# ---------------------------------------------------------------------------
# bytes, CRCs, deposits
# ---------------------------------------------------------------------------

def word_buffers(rng, B=5, W=64):
    """Word buffers with per-row byte lengths; bytes past each length are
    zero, as the CRC fold requires."""
    lens = rng.integers(3, 4 * W + 1, B).astype(np.int32)
    lens[0] = 4 * W
    raw = rng.integers(0, 256, (B, 4 * W)).astype(np.uint8)
    raw[np.arange(4 * W)[None, :] >= lens[:, None]] = 0
    words = raw.reshape(B, W, 4).astype(np.uint32)
    words = (words[..., 0] << 24) | (words[..., 1] << 16) | (
        words[..., 2] << 8) | words[..., 3]
    return raw, words.astype(np.uint32), lens


def test_words_to_bytes():
    raw, words, _ = word_buffers(np.random.default_rng(0))
    tb = tbp.words_to_bytes(T(words))
    assert tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), raw)
    np.testing.assert_array_equal(
        np.asarray(jbp.words_to_bytes(jnp.asarray(words))), tb.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc16_words(seed):
    raw, words, lens = word_buffers(np.random.default_rng(seed))
    got = tbp.crc16_words(T(words), T(lens))
    same(jbp.crc16_words(jnp.asarray(words), jnp.asarray(lens)), got)
    for i in range(len(lens)):
        assert int(got[i]) == tcrc.crc16(raw[i, :lens[i]].tobytes())


def test_crc8_prefix():
    rng = np.random.default_rng(4)
    buf = rng.integers(0, 256, (9, 20)).astype(np.uint8)
    lens = rng.integers(0, 17, 9).astype(np.int32)
    got = tbp.crc8_prefix(T(buf), T(lens), 16)
    same(jbp.crc8_prefix(jnp.asarray(buf), jnp.asarray(lens), 16), got)
    for i in range(9):
        assert int(got[i]) == tcrc.crc8(buf[i, :lens[i]].tobytes())


def test_deposit_byte():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (6, 64)).astype(np.uint8)
    idx = rng.integers(0, 64, 6).astype(np.int32)
    raw[np.arange(5), idx[:5]] = 0        # the target byte must be zero
    idx[-1] = 64                          # past the buffer: dropped
    words = raw.reshape(6, 16, 4).astype(np.uint32)
    words = ((words[..., 0] << 24) | (words[..., 1] << 16)
             | (words[..., 2] << 8) | words[..., 3]).astype(np.uint32)
    val = rng.integers(0, 256, 6).astype(np.uint32)
    got = tbp.deposit_byte(T(words), T(idx), T(val))
    same(jbp.deposit_byte(jnp.asarray(words), jnp.asarray(idx),
                          jnp.asarray(val)), got)
    out = tbp.words_to_bytes(got).numpy()
    np.testing.assert_array_equal(out[np.arange(5), idx[:5]], val[:5])
    np.testing.assert_array_equal(out[5], raw[5])


@pytest.mark.parametrize("width", [8, 16])
def test_batched_crc_device(width):
    rng = np.random.default_rng(width)
    buf = rng.integers(0, 256, (7, 40)).astype(np.uint8)
    lens = rng.integers(0, 41, 7).astype(np.int32)
    start = rng.integers(0, 5, 7).astype(np.int32)
    host = tcrc.crc8 if width == 8 else tcrc.crc16
    for st in (None, start):
        got = tcrc.batched_crc_device(
            T(buf), T(lens), width=width,
            start=None if st is None else T(st))
        same(jcrc.batched_crc_device(
            jnp.asarray(buf), jnp.asarray(lens), width=width,
            start=None if st is None else jnp.asarray(st)), got)
        for i in range(7):
            s = 0 if st is None else int(st[i])
            assert int(got[i]) == host(buf[i, s:max(s, lens[i])].tobytes())


def test_host_crc_tables_are_the_references():
    np.testing.assert_array_equal(tcrc.CRC8_TABLE, jcrc.CRC8_TABLE)
    np.testing.assert_array_equal(tcrc.CRC16_TABLE, jcrc.CRC16_TABLE)
    np.testing.assert_array_equal(tcrc._xpow_mod_np(0x8005, 16, 300),
                                  jcrc._xpow_mod_np(0x8005, 16, 300))
