"""flac_tpu_torch's subframe search and frame assembly against flac_tpu's
on the CPU, with the state carried across by
flac_tpu_torch.convert.

The subframe search mixes float analysis (autocorrelation, Levinson, the
order guess) with integer realization; on these signals both packages
must make the same choice for every subframe, so every field of the
choice is compared exactly.  Frame assembly is fed the reference's own
choice through `convert.choice_from_reference` and must pack the same
words in both layouts.  Whole batches are in test_torch_encode_batch.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import flac_tpu
from flac_tpu import encoder as jenc
from flac_tpu.models import frame as jframe
from flac_tpu.models import stereo as jst
from flac_tpu.models import subframe as jsub
from flac_tpu.ops import lpc as jlpc
from flac_tpu.ops import rice as jrice
from flac_tpu_torch import EncoderConfig as TConfig
from flac_tpu_torch import convert, signals
from flac_tpu_torch.models import frame as tframe
from flac_tpu_torch.models import subframe as tsub
from flac_tpu_torch.ops import lpc as tlpc

# xdist runs several workers side by side, each with JAX's own threads;
# one torch thread a worker keeps the port's many small CPU ops from
# oversubscribing the cores
torch.set_num_threads(1)


def T(a):
    return convert.tensor_from_reference(np.asarray(a))


def same(jax_out, torch_out, what=""):
    j = np.asarray(jax_out)
    j = j.view(np.int64) if j.dtype == np.uint64 else j.astype(np.int64)
    np.testing.assert_array_equal(j, torch_out.numpy().astype(np.int64),
                                  err_msg=what)


N = 1024


def blocks(kind, B=4, channels=2, bps=16, seed=0):
    """[B, C, N] int32 blocks of one of the test signals."""
    if kind == "music":
        pcm = signals.make_test_signal(B * N, channels, bps, seed=seed)
    elif kind == "burst":
        pcm = signals.make_transient_signal(B * N, channels, seed=seed)
    else:
        pcm = np.zeros((channels, B * N), np.int32)
    return np.ascontiguousarray(pcm.reshape(channels, B, N).transpose(1, 0, 2))


def configs(level, **kw):
    jc = flac_tpu.EncoderConfig.from_preset(level, blocksize=N, **kw)
    tc = convert.config_from_reference(dataclasses.asdict(jc))
    return jc.resolve(), tc.resolve()


# ---------------------------------------------------------------------------

def test_convert_helpers():
    jc = flac_tpu.EncoderConfig.from_preset(8, blocksize=N, channels=1)
    tc = convert.config_from_reference(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc == TConfig.from_preset(8, blocksize=N, channels=1)
    jb = jlpc.build_apodization_bank(N, jc.resolve().apodizations)
    tb = convert.bank_from_reference(jb.windows, jb.combine, jb.names)
    ob = tlpc.build_apodization_bank(N, tc.resolve().apodizations)
    np.testing.assert_array_equal(tb.windows, ob.windows)
    np.testing.assert_array_equal(tb.combine, ob.combine)
    assert tb.names == ob.names
    t = convert.tensor_from_reference(np.array([2 ** 32 - 1], np.uint32))
    assert t.dtype == torch.int64 and int(t[0]) == 2 ** 32 - 1
    t = convert.tensor_from_reference(np.array([2 ** 64 - 1], np.uint64))
    assert t.dtype == torch.int64 and int(t[0]) == -1
    with pytest.raises(ValueError):
        convert.choice_from_reference(bits=np.zeros(2, np.int32))


def test_utf8_fields():
    edges = [0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF,
             0x200000, 0x3FFFFFF, 0x4000000, 0x7FFFFFFF, 0x80000000,
             (1 << 36) - 1, 12345678901]
    n = np.array(edges, np.int64)
    jp, jb, jl = jframe._utf8_fields(jnp.asarray(n))
    tp, tb, tl = tframe._utf8_fields(T(n))
    same(jp, tp)
    same(jb, tb)
    same(jl, tl)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reference_search(pcm, cfg):
    bank = jenc._bank_for(cfg, N)
    x, bps_eff, wasted = jst.build_channel_candidates(pcm, cfg)
    choice = jsub.search_and_realize(x, bps_eff, wasted, cfg, bank)
    return x, bps_eff, wasted, choice


@functools.partial(jax.jit, static_argnames=("cfg", "layout"))
def _reference_assemble(pcm, x, choice, nums, cfg, layout):
    if cfg.loose_mid_side:
        assign, ch = jst.loose_assignment(pcm, cfg)
    else:
        assign, ch = jst.select_assignment(choice.bits, cfg)
    choice = jst.gather_channels(choice, ch)
    signal = jst.gather_channels(x, ch)
    return choice, signal, assign, jframe.assemble_frames(
        choice, signal, assign, nums, cfg, N, layout=layout)


@functools.lru_cache(maxsize=None)
def reference(level, kind, channels=2, bps=16, escape=False, ep=False):
    """One jitted reference search per case, shared by the tests below.
    ep: the exhaustive model search (-e) and the precision search (-p)."""
    jcfg, tcfg = configs(level, channels=channels, bits_per_sample=bps,
                         do_escape_coding=escape,
                         do_exhaustive_model_search=ep,
                         do_qlp_coeff_prec_search=ep)
    pcm = blocks(kind, channels=channels, bps=bps, seed=level)
    out = _reference_search(jnp.asarray(pcm), jcfg)
    return jcfg, tcfg, pcm, out


SEARCH_CASES = [  # (preset, signal, channels, bps, escape coding, -e -p)
    (0, "music", 2, 16, False, False),
    (1, "silence", 2, 16, False, False),
    (5, "music", 2, 16, False, False),
    (8, "burst", 2, 16, False, False),
    (5, "music", 1, 24, True, False),
    (3, "music", 2, 16, False, True),
    (5, "burst", 2, 16, True, False),
]


@pytest.mark.parametrize("case", SEARCH_CASES, ids=lambda v: str(v))
def test_search_and_realize(case):
    jcfg, tcfg, pcm, (x, bps_eff, wasted, jc) = reference(*case)
    bank = jenc._bank_for(jcfg, N)
    tbank = convert.bank_from_reference(bank.windows, bank.combine,
                                        bank.names)
    tc = tsub.search_and_realize(T(x), T(bps_eff), T(wasted), tcfg, tbank)
    for name in jsub.SubframeChoice._fields:
        same(getattr(jc, name), getattr(tc, name), name)
    if case[1] == "burst" and case[4]:
        # the clicks make raw (escaped) partitions cheapest somewhere
        assert (np.asarray(jc.params) >= jrice.ESCAPE_K_BASE).any()


ASSEMBLE_CASES = [  # (search case, layout, first frame number)
    (SEARCH_CASES[2], "quad", 0),
    (SEARCH_CASES[2], "safe", 1 << 20),
    (SEARCH_CASES[3], "quad", 70000),   # quad misfits: ok is False somewhere
    (SEARCH_CASES[3], "safe", 3),
    (SEARCH_CASES[1], "auto", (1 << 31) + 5),
    (SEARCH_CASES[4], "auto", 1),
    (SEARCH_CASES[6], "auto", 9),
]


@pytest.mark.parametrize("case,layout,first", ASSEMBLE_CASES,
                         ids=lambda v: str(v))
def test_assemble_frames(case, layout, first):
    """Both packages assemble the reference's choice into the same words,
    lengths and fit flags; the port's quad packer is K1's wrapper (its
    plain version on the CPU) and its explicit plain packer."""
    jcfg, tcfg, pcm, (x, _, _, jc) = reference(*case)
    nums = first + np.arange(pcm.shape[0], dtype=np.int64)
    jc, signal, assign, jp = _reference_assemble(
        jnp.asarray(pcm), x, jc, jnp.asarray(nums), jcfg, layout)
    tc = convert.choice_from_reference(
        **{k: np.asarray(v) for k, v in jc._asdict().items()})
    for packer in ("kernel", "plain"):
        tp = tframe.assemble_frames(tc, T(signal), T(assign), T(nums), tcfg,
                                    N, layout=layout, packer=packer)
        for name in ("words", "byte_len", "ok", "bits"):
            same(getattr(jp, name), getattr(tp, name), name)
    if case[1] == "burst" and layout == "quad":
        assert not tp.ok.all()
