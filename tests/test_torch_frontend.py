"""The encoder's front and back of the search in flac_tpu_torch against
flac_tpu, on the CPU: the plain versions of kernels K10 (the channel
candidates), K11 (the windowed autocorrelation) and K12 (the channel
assignment) on the corners of ops/frontend_synth.py.

- build_channel_candidates' plain versions (K10's:
  build_channel_candidates_plain, and loose_assignment on the loose path)
  against flac_tpu's build_channel_candidates and loose_assignment: the
  candidates (flac_tpu's float64 33-bit candidates as integers), bps_eff,
  wasted and the loose assignment equal, on int16 and int32 uploads;
- autocorrelation_plain (K11's) against flac_tpu's windows,
  autocorrelation and combine einsum (flac_tpu/models/subframe.py:
  148-156): within 2e-5 of each apodization's energy (the sum over its
  windows of |combine| x autoc_w[0]; flac_tpu's docstring bounds its
  float32 partial sums at ~1e-5 of autoc[0]); on the main path's -5 and
  -8 banks also within 1e-6 of the port's earlier float32 Gram product;
- assign_channels_plain (K12's) against flac_tpu/encoder.py:62-80
  (select_assignment, or the loose assignment given as its ch_index, both
  gather_channels and the limit_min_bitrate rule): every field equal;
- the dispatch: a CPU tensor takes the plain versions, a tensor on the
  card goes to the kernel's wrapper (which on a CPU tensor raises), the
  wrappers refuse malformed arguments, and their constants follow the
  sources;
- the encode's ranges: flac.candidates, flac.search, flac.assign,
  flac.assemble, once each.

The kernels themselves run in tests/test_torch_frontend_cuda.py (card
only).
"""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu import EncoderConfig as JConfig
from flac_tpu import format as jfmt
from flac_tpu.models import stereo as jst
from flac_tpu.ops import lpc as jlpc
from flac_tpu_torch import EncoderConfig, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.models import stereo
from flac_tpu_torch.models.subframe import SubframeChoice
from flac_tpu_torch.ops import assign_cuda, autoc_cuda, candidates_cuda, \
    frontend_synth
from flac_tpu_torch.ops import lpc as tlpc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CANDIDATE_CASES = frontend_synth.candidate_cases()
AUTOC_CASES = frontend_synth.autoc_cases()
ASSIGN_CASES = frontend_synth.assign_cases()


def _jconfig(cfg: EncoderConfig) -> JConfig:
    import dataclasses
    return JConfig(**dataclasses.asdict(cfg))


def _int64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reference_candidates(pcm, cfg):
    """flac_tpu's build_channel_candidates, and on the loose path its
    loose_assignment's assignment, of the int32 samples."""
    out = jst.build_channel_candidates(pcm, cfg)
    if pcm.shape[1] == 2 and cfg.do_mid_side and cfg.loose_mid_side:
        out += (jst.loose_assignment(pcm, cfg)[0],)
    return out


@pytest.mark.parametrize("label,case", CANDIDATE_CASES,
                         ids=[c[0] for c in CANDIDATE_CASES])
def test_candidates_plain_match_flac_tpu(label, case):
    pcm, cfg = frontend_synth.as_candidate_inputs(case, "cpu")
    got = stereo.build_channel_candidates(pcm, cfg)
    want = _reference_candidates(jnp.asarray(case["pcm"].astype(np.int32)),
                                 _jconfig(cfg))
    _, x64, loose = candidates_cuda.forms(pcm.shape[1], cfg)
    assert len(got) == len(want) == 3 + loose
    assert got[0].dtype == (torch.int64 if x64 else torch.int32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      _int64(w), err_msg=label)
    if label.startswith("-5, 16-bit, int"):
        # the corners: an all-zero L, wasted bits on L only, a side of
        # zeros
        wasted = got[2].numpy()
        assert wasted[0, 0] == 0 and (got[0][0, 0] == 0).all()
        assert wasted[1, 0] >= 2 and (wasted[1, 1:] == 0).all()
        assert (got[0][2, 3] == 0).all() and wasted[2, 3] == 0
    if loose:
        assert set(got[3].tolist()) == {0, 3}


@functools.partial(jax.jit, static_argnames=("O",))
def _reference_autoc(x, windows, combine, O):
    """flac_tpu's windows, autocorrelation and combine
    (flac_tpu/models/subframe.py:148-156), and each apodization's energy
    (the sum over its windows of |combine| x autoc_w[0])."""
    xw = x.astype(jnp.float32)[..., None, :] * windows
    autoc_w = jlpc.autocorrelation(xw, O)
    combine = combine.astype(jnp.float64)
    autoc = jnp.einsum("aw,...wl->...al", combine, autoc_w)
    energy = jnp.einsum("aw,...w->...a", jnp.abs(combine), autoc_w[..., 0])
    return autoc, energy


@pytest.mark.parametrize("label,case", AUTOC_CASES,
                         ids=[c[0] for c in AUTOC_CASES])
def test_autocorrelation_plain_matches_flac_tpu(label, case):
    args = frontend_synth.as_autoc_inputs(case, "cpu")
    got = tlpc.window_autocorrelation(*args).numpy()
    want, energy = (np.asarray(a) for a in _reference_autoc(
        *(jnp.asarray(case[k]) for k in ("x", "windows", "combine")),
        O=case["O"]))
    assert got.shape == want.shape
    bound = 2e-5 * energy[..., None] + 1e-9
    assert (np.abs(got - want) <= bound).all(), (
        label, float((np.abs(got - want) / (energy[..., None] + 1)).max()))
    assert (got.reshape(-1, got.shape[-1])[0] == 0).all()     # silence


@pytest.mark.parametrize("label", [c[0] for c in AUTOC_CASES[:2]])
def test_autocorrelation_plain_is_near_the_gram_product(label):
    """On the main path's -5 and -8 banks the new order stays within 1e-6
    of each window's energy of the port's earlier float32 Gram product
    (autocorrelation_gram, then the einsum)."""
    case = dict(AUTOC_CASES)[label]
    x, windows, combine, O = frontend_synth.as_autoc_inputs(case, "cpu")
    got = tlpc.autocorrelation_plain(x, windows, combine, O)
    xw = x.to(torch.float32)[..., None, :] * windows
    aw = tlpc.autocorrelation_gram(xw, O)
    gram = torch.einsum("aw,...wl->...al", combine, aw)
    energy = torch.einsum("aw,...w->...a", combine.abs(), aw[..., 0])
    assert ((got - gram).abs() <= 1e-6 * energy[..., None] + 1e-9).all()


@functools.partial(jax.jit, static_argnames=("limit_min_bitrate",))
def _reference_assign(c, x, loose, limit_min_bitrate):
    """flac_tpu/encoder.py:62-80 on the stereo mid-side path: the loose
    assignment (given) or select_assignment, both gather_channels, the
    limit_min_bitrate rule."""
    if loose is not None:
        assignment = loose
        ms = assignment == 3
        ch_index = jnp.stack([jnp.where(ms, jst.M, jst.L),
                              jnp.where(ms, jst.S, jst.R)],
                             axis=1).astype(jnp.int32)
    else:
        assignment, ch_index = jst.select_assignment(c["bits"], None)
    c = jst.gather_channels(c, ch_index)
    signal = jst.gather_channels(x, ch_index)
    if limit_min_bitrate:
        all_const = jnp.all(c["type_"] == jfmt.SUBFRAME_TYPE_CONSTANT,
                            axis=1)
        c["type_"] = c["type_"].at[:, -1].set(jnp.where(
            all_const, jfmt.SUBFRAME_TYPE_VERBATIM, c["type_"][:, -1]))
    return assignment, c, signal


@pytest.mark.parametrize("label,case", ASSIGN_CASES,
                         ids=[c[0] for c in ASSIGN_CASES])
def test_assign_channels_plain_matches_flac_tpu(label, case):
    choice, x, loose = frontend_synth.as_assign_inputs(case, "cpu")
    cfg = EncoderConfig(limit_min_bitrate=case["limit_min_bitrate"])
    assignment, got, signal = stereo.assign_channels(choice, x, loose, cfg,
                                                     mid_side=True)
    j_assignment, want, j_signal = _reference_assign(
        {k: jnp.asarray(v) for k, v in case["choice"].items()},
        jnp.asarray(case["x"]),
        None if case["loose"] is None else jnp.asarray(case["loose"]),
        case["limit_min_bitrate"])
    np.testing.assert_array_equal(assignment.numpy(), _int64(j_assignment))
    np.testing.assert_array_equal(signal.numpy(), np.asarray(j_signal))
    for name in SubframeChoice._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want[name]), err_msg=name)
    if label.startswith("equal totals"):
        assert (assignment[:4] == 0).all() and (assignment[4:] == 1).all()
    if case["limit_min_bitrate"]:
        # channel 1 of a frame of CONSTANT candidates becomes VERBATIM
        assert (got.type_[:2, 1] == jfmt.SUBFRAME_TYPE_VERBATIM).all()


def test_pass_through_paths_take_no_kernel(monkeypatch):
    """Without a mid-side search assign_channels gives the candidates as
    they are, an assignment of zeros and the limit_min_bitrate rule, with
    no kernel on any device."""
    def refuse(*a, **k):
        raise AssertionError("K12 was called off the mid-side path")
    monkeypatch.setattr(assign_cuda, "assign_channels", refuse)
    _, case = ASSIGN_CASES[1]
    choice, x, _ = frontend_synth.as_assign_inputs(case, "cpu")
    cfg = EncoderConfig(limit_min_bitrate=True)
    assignment, got, signal = stereo.assign_channels(choice, x, None, cfg,
                                                     mid_side=False)
    assert signal is x and (assignment == 0).all()
    want = choice.type_.clone()
    want[:, -1] = torch.where((choice.type_ == 0).all(dim=1), 1,
                              choice.type_[:, -1])
    assert torch.equal(got.type_, want)


def test_dispatch_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors the three dispatchers are their plain versions and
    never reach a kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")
    monkeypatch.setattr(candidates_cuda, "channel_candidates", refuse)
    monkeypatch.setattr(autoc_cuda, "window_autoc", refuse)
    monkeypatch.setattr(assign_cuda, "assign_channels", refuse)
    pcm, cfg = frontend_synth.as_candidate_inputs(CANDIDATE_CASES[9][1],
                                                  "cpu")
    got = stereo.build_channel_candidates(pcm, cfg)
    want = stereo.build_channel_candidates_plain(pcm, cfg) + (
        stereo.loose_assignment(pcm.int(), cfg)[0],)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = frontend_synth.as_autoc_inputs(AUTOC_CASES[0][1], "cpu")
    assert torch.equal(tlpc.window_autocorrelation(*args),
                       tlpc.autocorrelation_plain(*args))
    choice, x, loose = frontend_synth.as_assign_inputs(ASSIGN_CASES[3][1],
                                                       "cpu")
    cfg = EncoderConfig(limit_min_bitrate=True)
    got = stereo.assign_channels(choice, x, loose, cfg, mid_side=True)
    want = stereo.assign_channels_plain(choice, x, loose, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert candidates_cuda.launches == autoc_cuda.launches \
        == assign_cuda.launches == 0


@pytest.mark.parametrize("module, dispatch", [
    ("candidates_cuda", "channel_candidates"),
    ("autoc_cuda", "window_autoc"),
    ("assign_cuda", "assign_channels")])
def test_a_tensor_on_the_card_goes_to_the_kernel(module, dispatch,
                                                 monkeypatch):
    """K10, K11, K12: a tensor on the card goes to the kernel's wrapper and
    never to the plain version; the wrapper itself, given a CPU tensor,
    raises (there is no fallback)."""
    import importlib
    mod = importlib.import_module(f"flac_tpu_torch.ops.{module}")
    calls = []

    def refuse(*a, **k):
        raise AssertionError("the plain version took a tensor on the card")
    monkeypatch.setattr(stereo, "build_channel_candidates_plain", refuse)
    monkeypatch.setattr(stereo, "assign_channels_plain", refuse)
    monkeypatch.setattr(tlpc, "autocorrelation_plain", refuse)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    n_out = {"channel_candidates": 3, "window_autoc": 1,
             "assign_channels": 15}[dispatch]
    monkeypatch.setattr(mod, dispatch, lambda *a: calls.append(a) or (
        tuple(range(n_out)) if n_out > 1 else 0))
    cfg = EncoderConfig().resolve()
    if dispatch == "channel_candidates":
        stereo.build_channel_candidates(on_card, cfg)
    elif dispatch == "window_autoc":
        tlpc.window_autocorrelation(on_card, None, None, 8)
    else:
        stereo.assign_channels(SubframeChoice(*range(13)), on_card, None,
                               cfg, mid_side=True)
    assert len(calls) == 1 and on_card in calls[0]
    monkeypatch.undo()
    cpu_args = {
        "channel_candidates": frontend_synth.as_candidate_inputs(
            CANDIDATE_CASES[0][1], "cpu"),
        "window_autoc": frontend_synth.as_autoc_inputs(AUTOC_CASES[0][1],
                                                       "cpu"),
        "assign_channels": (*frontend_synth.as_assign_inputs(
            ASSIGN_CASES[0][1], "cpu"), False)}[dispatch]
    with pytest.raises(ValueError, match="not on a GPU"):
        getattr(mod, dispatch)(*cpu_args)


def test_wrappers_refuse_bad_arguments():
    pcm, _ = frontend_synth.as_candidate_inputs(CANDIDATE_CASES[0][1], "cpu")
    candidates_cuda.check_arguments(pcm)
    for bad in (pcm.long(), pcm.float(), pcm[0], pcm[..., :0]):
        with pytest.raises(ValueError):
            candidates_cuda.check_arguments(bad)
    x, w, c, O = frontend_synth.as_autoc_inputs(AUTOC_CASES[0][1], "cpu")
    autoc_cuda.check_arguments(x, w, c, O)
    for bad in ((x.float(), w, c, O), (x[0], w, c, O), (x, w.double(), c, O),
                (x, w[:, :8], c, O), (x, w, c.float(), O),
                (x, w, c[:, :0], O), (x, w, c, 0), (x, w, c, 33),
                (x[..., :8], w[:, :8], c, 8)):
        with pytest.raises(ValueError):
            autoc_cuda.check_arguments(*bad)
    choice, x, loose = frontend_synth.as_assign_inputs(ASSIGN_CASES[3][1],
                                                       "cpu")
    assign_cuda.check_arguments(choice, x, loose)
    assign_cuda.check_arguments(choice, x, None)
    for name in SubframeChoice._fields:
        t = getattr(choice, name)
        for wrong in (t.to(torch.int16), t[:, :2]):
            with pytest.raises(ValueError):
                assign_cuda.check_arguments(choice._replace(**{name: wrong}),
                                            x, loose)
    for bad in ((choice, x.float(), loose), (choice, x[:, :2], loose),
                (choice, x, loose.long()), (choice, x, loose[:1])):
        with pytest.raises(ValueError):
            assign_cuda.check_arguments(*bad)


def test_constants_mirror_the_sources():
    """The wrappers' constants and template choices follow the sources."""
    csrc = REPO / "flac_tpu_torch" / "csrc"
    k10 = (csrc / "channel_candidates.cu").read_text()
    assert f"constexpr int THREADS = {candidates_cuda.THREADS};" in k10
    assert f"constexpr int SPLIT = {candidates_cuda.SPLIT};" in k10
    assert "constexpr int STAGE_BYTES = %d * 1024;" % (
        candidates_cuda.STAGE_BYTES // 1024) in k10
    assert "const int staged = (ms ? 2 : 1) * (long long)share * 4 " \
        "<= STAGE_BYTES;" in k10
    assert "const int split = units < sms ? SPLIT : 1;" in k10
    assert "const int share = ((N + split - 1) / split + 7) & ~7;" in k10
    assert [candidates_cuda.share(n, 2) for n in (1, 33, 1152, 4096)] \
        == [8, 24, 576, 2048]
    assert candidates_cuda.share(4096, 1) == 4096
    k11 = (csrc / "window_autoc.cu").read_text()
    for name, value in (("COLS", autoc_cuda.COLUMNS_A_LANE),
                        ("LANES", autoc_cuda.LANES),
                        ("THREADS", autoc_cuda.THREADS),
                        ("TILE", autoc_cuda.TILE),
                        ("HALO", autoc_cuda.MAX_LAG),
                        ("MAX_ROWS", autoc_cuda.MAX_ROWS),
                        ("WPASS", autoc_cuda.WPASS),
                        ("ONE_THREADS", autoc_cuda.ONE_THREADS)):
        assert f"constexpr int {name} = {value};" in k11, name
    # a lane's columns times a warp's lanes: one block of the Gram product
    assert autoc_cuda.COLUMNS_A_LANE * autoc_cuda.LANES \
        == tlpc.AUTOC_COLUMNS
    assert "return maxlag <= 12 ? maxlag + 1 : 12;" in k11
    assert "if (a.W == 1) {" in k11
    for t in autoc_cuda.TEMPLATE_LAGS[:-1]:
        assert f"if (a.O <= {t}) return launch_with<X, {t}>" in k11
        assert f"if (a.O <= {t}) return launch_one_window<X, {t}>" in k11
    assert [autoc_cuda.template_lag(O) for O in (1, 8, 9, 12, 13, 32)] \
        == [8, 8, 12, 12, 32, 32]
    assert [autoc_cuda.part_lags(O) for O in (8, 12, 32)] == [9, 13, 12]
    # one window (-5): a CTA of 128 threads a row; several (-8): two rows
    # a CTA of 384, order 32 in three lag parts
    assert [(p["threads"], p["rows"], p["wpass"], p["parts"], p["ctas"])
            for p in (autoc_cuda.plan(256, 1, 8),
                      autoc_cuda.plan(256, 6, 12),
                      autoc_cuda.plan(3, 2, 32))] \
        == [(128, 1, 1, 1, 256), (384, 2, 6, 1, 128), (384, 2, 2, 3, 2)]
    k12 = (csrc / "assign_channels.cu").read_text()
    assert f"constexpr int THREADS = {assign_cuda.THREADS};" in k12
    assert "__constant__ int CH0[4] = {%s};" % ", ".join(
        map(str, stereo._ASSIGN_CH0)) in k12
    assert "__constant__ int CH1[4] = {%s};" % ", ".join(
        map(str, stereo._ASSIGN_CH1)) in k12
    cfg5 = EncoderConfig.from_preset(5).resolve()
    # on an H100's 132 SMs: two CTAs a frame at -5's 64 frames (and -0's
    # 128 (frame, channel)s), one at the sharded form's 256
    assert candidates_cuda.ctas(64, 2, cfg5, 132) \
        == 64 * candidates_cuda.SPLIT
    assert candidates_cuda.ctas(64, 2, EncoderConfig.from_preset(
        0).resolve(), 132) == 128 * candidates_cuda.SPLIT
    assert candidates_cuda.ctas(256, 2, cfg5, 132) == 256
    assert candidates_cuda.staged(2, 4096, cfg5, 2) \
        and candidates_cuda.staged(2, 4096, cfg5, 1) \
        and not candidates_cuda.staged(1, 32768, cfg5, 2)


def test_encode_ranges():
    """An encode batch marks flac.candidates (K10), flac.search,
    flac.assign (K12) and flac.assemble, once each and in that order."""
    from torch.profiler import ProfilerActivity, profile
    cfg = EncoderConfig.from_preset(5, blocksize=256).resolve()
    pcm = signals.make_test_signal(4 * 256, seed=3)
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, 4, 256).transpose(1, 0, 2)).astype(np.int16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        encoder_mod.encode_batch(x, 0, cfg, 256)
    names = [e.name for e in prof.events()
             if e.name in ("flac.candidates", "flac.search", "flac.assign",
                           "flac.assemble")]
    assert names == ["flac.candidates", "flac.search", "flac.assign",
                     "flac.assemble"]
