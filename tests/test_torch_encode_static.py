"""flac_tpu_torch's encode_batch is a static program: on the CPU it reads
nothing back from its tensors and, on a warm call, builds nothing from
host memory.  On a CUDA device both would stop its capture as a CUDA
graph (encoder._EncodePrograms); here they are caught in Python.

- The sync sentinel patches the Python conversions of a tensor to a host
  value (`item`, `__int__`, `__float__`, `__bool__`, `__index__`,
  `tolist`) to raise while encode_batch runs.
- The spy counts tensors built from host data (`torch.tensor`,
  `torch.as_tensor`, `torch.asarray` and `torch.from_numpy` of anything
  but a tensor, and `Tensor.to` calls that move a tensor to another
  device): a cold call builds its constants, a warm call of the same key
  builds none.
- lpc_residual's tap loop takes a static bound from its caller; its
  residuals equal flac_tpu's and those of the old cut at the highest
  order present (`int(orders.max())`, a read-back).

Only the lpc_residual tests run flac_tpu (JAX ops on small shapes, no
jit); the card's side is tests/test_torch_compiled_cuda.py and
chip_smoke.py (under torch.cuda.set_sync_debug_mode("error")).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_tpu.ops import lpc as jlpc
from flac_tpu_torch import EncoderConfig, device as device_mod, signals
from flac_tpu_torch import encoder as encoder_mod
from flac_tpu_torch.models import subframe as subframe_mod
from flac_tpu_torch.ops import lpc as tlpc

torch.set_num_threads(1)

N = 512
B = 3

# (label, preset, EncoderConfig overrides, bits per sample, layout)
CASES = {
    "-0": (0, {}, 16, "auto"),
    "-5": (5, {}, 16, "auto"),
    "-8": (8, {}, 16, "auto"),
    "-5 -e -p": (5, dict(do_exhaustive_model_search=True,
                         do_qlp_coeff_prec_search=True), 16, "auto"),
    "24-bit (f64 residuals)": (5, {}, 24, "auto"),
    "32-bit stereo (33-bit side)": (5, {}, 32, "auto"),
    "safe layout": (5, {}, 16, "safe"),
    "mono, loose mid-side off": (3, dict(channels=1), 16, "auto"),
}


def _case(label):
    level, kw, bps, layout = CASES[label]
    cfg = EncoderConfig.from_preset(level, blocksize=N, bits_per_sample=bps,
                                    **kw).resolve()
    pcm = signals.make_test_signal(B * N, cfg.channels, bps, seed=len(label))
    blocks = np.ascontiguousarray(
        pcm.reshape(cfg.channels, B, N).transpose(1, 0, 2))
    return cfg, torch.from_numpy(blocks), layout


def _raise(*a, **k):
    raise AssertionError("encode_batch read a tensor back to the host")


@contextlib.contextmanager
def _no_read_back(monkeypatch):
    with monkeypatch.context() as m:
        for name in ("item", "__int__", "__float__", "__bool__", "__index__",
                     "tolist"):
            m.setattr(torch.Tensor, name, _raise)
        yield


def _moves_device(t, args, kwargs):
    """Whether a Tensor.to call names a device other than t's."""
    for a in list(args) + [kwargs.get("device")]:
        if isinstance(a, (str, torch.device)) and \
                torch.device(a) != t.device:
            return True
    return False


@contextlib.contextmanager
def _host_builds(monkeypatch):
    """Count the tensors built from host data inside the block."""
    built = []
    with monkeypatch.context() as m:
        for name in ("tensor", "as_tensor", "asarray", "from_numpy"):
            real = getattr(torch, name)

            def spy(data, *a, _real=real, _name=name, **k):
                if not isinstance(data, torch.Tensor):
                    built.append(_name)
                return _real(data, *a, **k)
            m.setattr(torch, name, spy)
        real_to = torch.Tensor.to

        def spy_to(self, *a, **k):
            if _moves_device(self, a, k):
                built.append("Tensor.to")
            return real_to(self, *a, **k)
        m.setattr(torch.Tensor, "to", spy_to)
        yield built


def _cold_caches():
    device_mod._CONSTANTS.clear()
    encoder_mod._bank_for.cache_clear()


@pytest.mark.parametrize("label", list(CASES))
def test_encode_batch_reads_nothing_back(monkeypatch, label):
    cfg, pcm, layout = _case(label)
    expect = encoder_mod.encode_batch(pcm, 7, cfg, N, layout=layout)
    with _no_read_back(monkeypatch):
        got = encoder_mod.encode_batch(pcm, 7, cfg, N, layout=layout)
    for a, b in zip(expect, got):
        assert torch.equal(a, b)


def test_per_frame_numbers_read_nothing_back(monkeypatch):
    """The safe re-encode's [B] form: each frame its own number."""
    cfg, pcm, _ = _case("-5")
    nums = torch.tensor([40, 2, 9], dtype=torch.int64)
    with _no_read_back(monkeypatch):
        got = encoder_mod.encode_batch(pcm, nums - torch.arange(3), cfg, N,
                                       layout="safe")
    for i, n in enumerate((40, 2, 9)):
        one = encoder_mod.encode_batch(pcm[i:i + 1], n, cfg, N,
                                       layout="safe")
        assert torch.equal(one.words[0], got.words[i])


def test_trimmed_encode_reads_nothing_back(monkeypatch):
    cfg, pcm, _ = _case("-5")
    pcm16 = pcm.to(torch.int16)
    with _no_read_back(monkeypatch):
        main, rest = encoder_mod.encode_batch_trimmed(pcm16, 3, cfg, N, 100)
    pf = encoder_mod.encode_batch(pcm, 3, cfg, N)
    assert torch.equal(main[:, 0], pf.byte_len)
    assert torch.equal(main[:, 1:].to(torch.int64) & 0xFFFFFFFF,
                       pf.words[:, :100])
    assert torch.equal(rest, pf.words[:, 100:])


@pytest.mark.parametrize("label", ["-5", "-8", "-5 -e -p",
                                   "24-bit (f64 residuals)",
                                   "32-bit stereo (33-bit side)",
                                   "safe layout"])
def test_warm_call_builds_nothing_from_host_memory(monkeypatch, label):
    cfg, pcm, layout = _case(label)
    _cold_caches()
    with _host_builds(monkeypatch) as cold:
        encoder_mod.encode_batch(pcm, 0, cfg, N, layout=layout)
    with _host_builds(monkeypatch) as warm:
        encoder_mod.encode_batch(pcm, B, cfg, N, layout=layout)
    assert cold, "the spy saw no constant being built"
    assert warm == []


def test_warm_trimmed_call_builds_nothing_from_host_memory(monkeypatch):
    cfg, pcm, _ = _case("-0")
    pcm16 = pcm.to(torch.int16)
    _cold_caches()
    with _host_builds(monkeypatch) as cold:
        encoder_mod.encode_batch_trimmed(pcm16, 0, cfg, N, 64)
    with _host_builds(monkeypatch) as warm:
        encoder_mod.encode_batch_trimmed(pcm16, B, cfg, N, 64)
    assert cold and warm == []


def test_spy_counts_a_device_move():
    t = torch.zeros(2)
    assert _moves_device(t, ("meta",), {})
    assert _moves_device(t, (), {"device": "meta"})
    assert not _moves_device(t, (torch.int32,), {})
    assert not _moves_device(t, ("cpu",), {})


def test_constants_are_built_once_a_device():
    calls = []

    def make(dev):
        calls.append(dev)
        return torch.arange(3, device=dev)
    a = device_mod.constant(("test table", 3), torch.device("cpu"), make)
    b = device_mod.constant(("test table", 3), "cpu", make)
    assert a is b and len(calls) == 1
    device_mod.constant(("test table", 4), "cpu", make)
    assert len(calls) == 2


def test_programs_run_op_by_op_on_the_cpu():
    progs = encoder_mod._EncodePrograms()
    x = torch.arange(4)
    for _ in range(3):
        assert torch.equal(progs.run("double", lambda t: t * 2, x), x * 2)
    assert not progs.seen and not progs.graphs


@pytest.mark.parametrize("first", [5, np.int64(5),
                                   torch.tensor([5, 4, 3])])
def test_frame_numbers(first):
    got = encoder_mod._frame_numbers(first, 3, torch.device("cpu"))
    assert got.dtype == torch.int64
    want = [5, 6, 7] if not isinstance(first, torch.Tensor) else [5, 5, 5]
    assert got.tolist() == want


# ---------------------------------------------------------------------------
# lpc_residual's static bound
# ---------------------------------------------------------------------------

def _residual_inputs(bps, top_order, seed):
    rng = np.random.default_rng(seed)
    n, A = 200, 4
    amp = 1 << (bps - 3)
    x = rng.integers(-amp, amp, (2, 3, n)).astype(np.int32)
    q = rng.integers(-(1 << 11), 1 << 11, (2, 3, A, 32)).astype(np.int32)
    orders = rng.integers(1, top_order + 1, (2, 3, A)).astype(np.int32)
    orders[0, 0, 0] = top_order
    q[np.arange(32) >= orders[..., None]] = 0
    shift = rng.integers(0, 16, (2, 3, A)).astype(np.int32)
    bps_eff = np.full((2, 3), bps, np.int32)
    return x, q, shift, orders, bps_eff


@pytest.mark.parametrize("mode, bps, top_order, bound", [
    ("i32", 16, 5, 8), ("i32", 16, 8, 8), ("i32", 17, 6, 32),
    ("f64", 24, 7, 12)])
def test_static_bound_matches_flac_tpu_and_the_old_cut(mode, bps,
                                                       top_order, bound):
    """The static bound (the configuration's max order) gives the
    residuals and validity of flac_tpu's loop over all 32 taps, and of
    the old loop cut at the highest order present."""
    x, q, shift, orders, bps_eff = _residual_inputs(bps, top_order, bound)
    jr, jok = jlpc.lpc_residual(jnp.asarray(x), jnp.asarray(q),
                                jnp.asarray(shift), jnp.asarray(orders),
                                jnp.asarray(bps_eff), mode)
    args = [torch.from_numpy(a) for a in (x, q, shift, orders, bps_eff)]
    tr, tok = tlpc.lpc_residual(*args, mode, max_order=bound)
    cut_r, cut_ok = tlpc.lpc_residual(*args, mode,
                                      max_order=int(orders.max()))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tok.any()
    keep = tok.numpy()
    np.testing.assert_array_equal(np.asarray(jr)[keep], tr.numpy()[keep])
    assert torch.equal(tr, cut_r) and torch.equal(tok, cut_ok)


@pytest.mark.parametrize("level, n, bound", [(5, 512, 8), (8, 512, 12),
                                             (8, 9, 8)])
def test_search_passes_the_configuration_bound(monkeypatch, level, n,
                                               bound):
    """search_and_realize hands lpc_residual min(max_lpc_order, N - 1),
    a Python int."""
    seen = []
    real = tlpc.lpc_residual

    def spy(*a, **k):
        seen.append(k["max_order"])
        return real(*a, **k)
    monkeypatch.setattr(tlpc, "lpc_residual", spy)
    cfg = EncoderConfig.from_preset(level, blocksize=n).resolve()
    pcm = signals.make_test_signal(2 * n, seed=3)
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, 2, n).transpose(1, 0, 2)))
    bps = torch.full((2, 2), 16, dtype=torch.int32)
    subframe_mod.search_and_realize(
        x, bps, torch.zeros((2, 2), dtype=torch.int32), cfg,
        tlpc.build_apodization_bank(n, cfg.apodizations))
    assert seen == [bound] and isinstance(seen[0], int)
