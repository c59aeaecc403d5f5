"""Frame assembly in three steps (models/frame.py): the field lists
(assemble_fields_plain, the plain version of kernel K4), the pack and the
CRC seal (seal_frames_plain, the plain version of K5), on the CPU.

- the three plain steps against flac_tpu's jitted assemble_frames on the
  reference's own subframe choice (words, byte lengths, fit flags, bits):
  the 33-bit side's wide pairs, a 3072-sample block at 37800 Hz (both
  header tails, 16 bits each), mono 24-bit with 7-byte frame numbers and
  a batch of one frame;
- the plain seal against the host CRC-8 and CRC-16 (ops/crc.py) on every
  frame of ops/assemble_synth.py's corners, and against its host seal on
  K5's own corners (`seal_cases`) inside the plain version's domain;
- K5's host tables (ops/seal_cuda.py: the slicing tables, the tables of
  the constant powers x^(64 * 2^l), the CRC-8 bit table) against a
  bitwise CRC in Python on random messages and split points, and K5's
  arithmetic (end-aligned pairs, Horner, the tree, the partial pair, the
  zeros past the row, the CRC-8 folded into its word) mirrored in numpy
  at each cluster size against the host seal;
- ops/assemble_cuda.field_layout (K4's static layout) against the plain
  version's concatenated field list: the count and each segment's fields;
- the wrappers: the plain versions for CPU tensors, and ValueError for a
  wrong dtype, shape or device.

The kernels themselves run in tests/test_torch_assemble_cuda.py (card
only).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flac_tpu
from flac_tpu import encoder as jenc
from flac_tpu.models import frame as jframe
from flac_tpu.models import stereo as jst
from flac_tpu.models import subframe as jsub
from flac_tpu_torch import EncoderConfig, convert, signals
from flac_tpu_torch.models import frame
from flac_tpu_torch.ops import (assemble_cuda, assemble_synth, bitpack, crc,
                                seal_cuda)

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("cfg", "N"))
def _reference(pcm, nums, cfg, N):
    """flac_tpu's encode_batch, returning the gathered choice, signal and
    assignment beside the frames."""
    x, bps_eff, wasted = jst.build_channel_candidates(pcm, cfg)
    choice = jsub.search_and_realize(x, bps_eff, wasted, cfg,
                                     jenc._bank_for(cfg, N))
    if pcm.shape[1] == 2 and cfg.do_mid_side:
        assign, ch = jst.select_assignment(choice.bits, cfg)
        choice = jst.gather_channels(choice, ch)
        signal = jst.gather_channels(x, ch)
    else:
        assign = jnp.zeros((pcm.shape[0],), jnp.int32)
        signal = x
    return choice, signal, assign, jframe.assemble_frames(
        choice, signal, assign, nums, cfg, N)


def _pcm(kind, B, C, N, bps, seed):
    if kind == "antiphase":
        # 32-bit stereo music, its first block antiphase so that the side
        # passes 2^31 (the 33-bit side; odd, so no wasted bit halves it)
        pcm = signals.make_hires32_signal(B * N, seed=seed)
        left = np.round(1.6e9 * np.sin(np.arange(N) * 0.01))
        pcm[0, :N], pcm[1, :N] = left, -left - (np.arange(N) & 1)
    else:
        pcm = signals.make_test_signal(B * N, C, bps, seed=seed)
    return np.ascontiguousarray(
        pcm.reshape(C, B, N).transpose(1, 0, 2)).astype(np.int32)


REFERENCE_CASES = {  # (preset, kind, B, C, N, bps, rate, first frame)
    "wide pairs, 32-bit stereo": (5, "antiphase", 3, 2, 1024, 32, 96000, 5),
    "3072 samples at 37800 Hz": (5, "music", 3, 2, 3072, 16, 37800, 40),
    "mono 24-bit, 7-byte numbers": (8, "music", 3, 1, 1024, 24, 48000,
                                    (1 << 31) - 1),
    "a batch of one frame": (5, "music", 1, 2, 1024, 16, 44100, 7),
}


@pytest.mark.parametrize("label", list(REFERENCE_CASES))
def test_three_steps_against_flac_tpu(label):
    level, kind, B, C, N, bps, rate, first = REFERENCE_CASES[label]
    kw = dict(blocksize=N, channels=C, bits_per_sample=bps,
              sample_rate=rate)
    jcfg = flac_tpu.EncoderConfig.from_preset(level, **kw).resolve()
    tcfg = EncoderConfig.from_preset(level, **kw).resolve()
    pcm = _pcm(kind, B, C, N, bps, seed=level + N)
    nums = first + np.arange(B, dtype=np.int64)
    jc, signal, assign, jp = _reference(jnp.asarray(pcm), jnp.asarray(nums),
                                        jcfg, N)
    tc = convert.choice_from_reference(
        **{k: np.asarray(v) for k, v in jc._asdict().items()})
    T = convert.tensor_from_reference
    args = (tc, T(np.asarray(signal)), T(np.asarray(assign)), T(nums), tcfg,
            N)
    f = frame.assemble_fields_plain(*args)
    P = tc.params.shape[-1]
    quad, wide = frame.resolve_layout(tcfg, N, P, "auto")
    W = frame.max_words(tcfg, C, N, P)
    pack = bitpack.pack_fields64 if quad else bitpack.pack_fields
    words, total_bits = pack(f.nzeros, f.payload, f.pbits, W)
    byte_len = total_bits // 8
    words = frame.seal_frames_plain(words, byte_len, f.hdr_bytes)
    composed = frame.assemble_frames(*args)
    for name, got in (("words", words), ("byte_len", byte_len),
                      ("ok", f.ok), ("bits", f.bits)):
        want = np.asarray(getattr(jp, name))
        want = want.view(np.int64) if want.dtype == np.uint64 \
            else want.astype(np.int64)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want,
                                      err_msg=name)
        np.testing.assert_array_equal(
            getattr(composed, name).numpy().astype(np.int64), want,
            err_msg=f"assemble_frames {name}")
    assert (byte_len <= 4 * W).all()
    if kind == "antiphase":
        assert wide and (tc.bps_eff == 33).any()


SYNTH = assemble_synth.cases()


def _plain_chain(case):
    args = assemble_synth.as_inputs(case, "cpu")
    f = frame.assemble_fields_plain(*args)
    choice, signal, _, _, cfg, _, layout = args
    B, C, N = signal.shape
    P = choice.params.shape[-1]
    quad, wide = frame.resolve_layout(cfg, N, P, layout)
    return args, f, quad, wide, frame.max_words(cfg, C, N, P)


@pytest.mark.parametrize("label,case", SYNTH, ids=[c[0] for c in SYNTH])
def test_plain_seal_matches_host_crc(label, case):
    _, f, quad, _, W = _plain_chain(case)
    pack = bitpack.pack_fields64 if quad else bitpack.pack_fields
    words, total_bits = pack(f.nzeros, f.payload, f.pbits, W)
    byte_len = total_bits // 8
    sealed = frame.seal_frames_plain(words, byte_len, f.hdr_bytes)
    assert (byte_len <= 4 * W).all()
    for b in range(words.shape[0]):
        raw = bitpack.words_to_bytes(sealed[b:b + 1])[0].numpy()
        n, hb = int(byte_len[b]), int(f.hdr_bytes[b])
        assert not raw[n:].any()
        assert raw[hb] == crc.crc8(raw[:hb])
        assert (int(raw[n - 2]) << 8 | int(raw[n - 1])) == crc.crc16(
            raw[:n - 2])


@pytest.mark.parametrize("label,case", SYNTH, ids=[c[0] for c in SYNTH])
def test_field_layout_matches_the_plain_list(label, case):
    args, f, quad, wide, _ = _plain_chain(case)
    choice, signal = args[0], args[1]
    B, C, N = signal.shape
    lay = assemble_cuda.field_layout(C, N, choice.params.shape[-1], quad,
                                     wide)
    assert f.nzeros.shape == (B, lay.F)
    seg = {name: (at, n) for name, at, n in lay.segments}
    ends = [at + n for _, at, n in lay.segments]
    assert [at for _, at, _ in lay.segments] == [0] + ends[:-1]
    assert ends[-1] == lay.F
    pb, pay, nz = f.pbits, f.payload, f.nzeros

    def at(name, width=None):
        a, n = seg[name]
        return slice(a, a + (n if width is None else width))
    assert (pb[:, at("header")] == 32).all()
    assert (pb[:, at("crc8")] == 8).all() and (pb[:, at("crc16")] == 16).all()
    assert (pay[:, at("crc8")] == 0).all()
    assert torch.equal(pb[:, at("utf8")].sum(1) // 8 + 4
                       + (pb[:, at("blocksize tail")]
                          + pb[:, at("rate tail")])[:, 0] // 8,
                       f.hdr_bytes)
    pad = nz[:, seg["padding"][0]]
    assert torch.equal(pad, torch.remainder(-f.bits, 8))
    assert (pb[:, seg["padding"][0]] == 0).all()
    for c in range(C):
        t, o = choice.type_[:, c], choice.order[:, c]
        is_l = t == 3
        has_res = (t == 2) | is_l
        assert (pb[:, at(f"type {c}")] == 8).all()
        assert torch.equal(nz[:, seg[f"wasted {c}"][0]],
                           torch.clamp(choice.wasted[:, c] - 1, min=0))
        assert torch.equal(pb[:, seg[f"precision/shift {c}"][0]],
                           torch.where(is_l, 9, 0).to(torch.int32))
        coef = pb[:, at(f"coefficients {c}")]
        j = torch.arange(32)
        assert torch.equal(coef, torch.where(
            is_l[:, None] & (j < o[:, None]),
            choice.precision[:, c, None], 0).to(torch.int32))
        assert torch.equal(pay[:, seg[f"method/order {c}"][0]],
                           (choice.use_rice2[:, c].long() << 4)
                           | choice.po[:, c].long())
        assert torch.equal(pb[:, seg[f"method/order {c}"][0]],
                           torch.where(has_res, 6, 0).to(torch.int32))
        warm = pb[:, at(f"warm-up {c}")]
        assert warm.shape[1] == (64 if wide else 32)
        groups = pb[:, at(f"groups {c}")].reshape(B, lay.G, 1 + lay.per)
        # a group's prefix slot carries bits only where a partition starts
        starts = torch.arange(lay.G)[None, :] % (
            (1 << lay.max_po) >> choice.po[:, c, None]) == 0
        assert not (groups[:, :, 0].bool()
                    & ~(starts & has_res[:, None])).any()


def test_field_layout_rejects_what_it_cannot_hold():
    with pytest.raises(ValueError, match="channels"):
        assemble_cuda.field_layout(9, 1024, 8, False, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        assemble_cuda.field_layout(2, 4048, 16, True, False)
    with pytest.raises(ValueError, match="smallest partition"):
        assemble_cuda.field_layout(2, 4048, 256, False, False)
    lay = assemble_cuda.field_layout(2, 4096, 32, True, False)
    assert (lay.F, lay.per, lay.G) == (2263, 32, 32)


def test_cluster_size_mirrors_the_source():
    """assemble_cuda.cluster_size, K4's CTAs a frame, follows the source's
    constants and rule: 8 a frame, halved while a launch would pass 512
    CTAs."""
    src = (Path(assemble_cuda.__file__).parents[1] / "csrc"
           / "assemble_fields.cu").read_text()
    assert f"constexpr int CLUSTER = {assemble_cuda.CLUSTER};" in src
    assert f"constexpr int CTA_TARGET = {assemble_cuda.CTA_TARGET};" in src
    assert "while (nc > 1 && (long long)a.B * nc > CTA_TARGET) nc >>= 1;" \
        in src
    sizes = {B: assemble_cuda.cluster_size(B)
             for B in (1, 3, 64, 65, 133, 256, 1024)}
    assert sizes == {1: 8, 3: 8, 64: 8, 65: 4, 133: 2, 256: 2, 1024: 1}


def test_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    label, case = SYNTH[0]
    args = assemble_synth.as_inputs(case, "cpu")
    calls = []
    for name in ("assemble_fields_plain", "seal_frames_plain"):
        real = getattr(frame, name)
        monkeypatch.setattr(frame, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    packed = frame.assemble_frames(*args)
    assert calls == ["assemble_fields_plain", "seal_frames_plain"]
    with pytest.raises(ValueError, match="not on a GPU"):
        assemble_cuda.assemble_fields_cuda(*args[:6], True, False)
    with pytest.raises(ValueError, match="not on a GPU"):
        seal_cuda.seal_frames_cuda(packed.words, packed.byte_len,
                                   packed.bits)
    with pytest.raises(ValueError, match="unsupported device"):
        frame.seal_frames(packed.words.to("meta"), packed.byte_len,
                          packed.bits)


@pytest.mark.parametrize("fault", ["dtype", "shape", "device"])
def test_k4_arguments_raise(fault):
    _, case = SYNTH[2]
    choice, signal, assign, nums, cfg, N, _ = assemble_synth.as_inputs(
        case, "cpu")
    if fault == "dtype":
        choice = choice._replace(order=choice.order.long())
    elif fault == "shape":
        choice = choice._replace(residual=choice.residual[..., :-4])
    else:
        nums = nums.to("meta")
    match = {"dtype": "order is torch.int64", "shape": "residual has shape",
             "device": "frame_numbers is on meta"}[fault]
    with pytest.raises(ValueError, match=match):
        assemble_cuda.launch_arguments(choice, signal, assign, nums, cfg, N,
                                       False, False)


@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "narrow"])
def test_k5_arguments_raise(fault):
    words = torch.zeros((3, 64), dtype=torch.int64)
    byte_len = torch.full((3,), 20, dtype=torch.int32)
    hdr = torch.full((3,), 6, dtype=torch.int32)
    if fault == "dtype":
        byte_len = byte_len.long()
    elif fault == "shape":
        hdr = hdr[:2]
    elif fault == "strided":
        words = torch.zeros((3, 128), dtype=torch.int64)[:, ::2]
    else:
        words = words[:, :3].contiguous()
    with pytest.raises(ValueError):
        seal_cuda.check_arguments(words, byte_len, hdr)
    seal_cuda.check_arguments(torch.zeros((3, 64), dtype=torch.int64),
                              torch.full((3,), 20, dtype=torch.int32),
                              torch.full((3,), 6, dtype=torch.int32))


def test_byte_shift_powers_append_zero_bytes():
    """Multiplying a CRC-16 remainder by K5's table entries appends zero
    bytes to its message."""
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 256, 50).astype(np.uint8)
    tab = crc.byte_shift_powers(crc.CRC16_POLY, 16, 32)
    for zeros in (0, 1, 5, 37, 300):
        r = crc.crc16(msg)
        for i in range(32):
            if (zeros >> i) & 1:
                r = crc.mulmod(r, int(tab[i]), crc.CRC16_POLY, 16)
        assert r == crc.crc16(np.r_[msg, np.zeros(zeros, np.uint8)])


SEAL = assemble_synth.seal_cases()
SEAL_PLAIN = [c for c in SEAL if c[1]["plain"]]


@pytest.mark.parametrize("label,case", SEAL_PLAIN,
                         ids=[c[0] for c in SEAL_PLAIN])
def test_plain_seal_matches_the_host_seal_on_k5_corners(label, case):
    words, byte_len, hdr = assemble_synth.as_seal_inputs(case, "cpu")
    got = frame.seal_frames_plain(words, byte_len, hdr).numpy()
    want = assemble_synth.seal_host(case["words"], case["byte_len"],
                                    case["hdr_bytes"])
    np.testing.assert_array_equal(got, want)


def _crc_bits(msg, poly: int, width: int) -> int:
    """A CRC (init 0, MSB first) one bit at a time."""
    r, top, mask = 0, 1 << (width - 1), (1 << width) - 1
    for byte in msg:
        for k in range(7, -1, -1):
            fb = bool(r & top) ^ bool((int(byte) >> k) & 1)
            r = (r << 1) & mask
            if fb:
                r ^= poly
    return r


def test_k5_slicing_and_crc8_tables_against_a_bitwise_crc():
    sl = seal_cuda.slicing_tables()
    for i in range(8):
        for b in range(256):
            assert sl[i, b] == _crc_bits([b] + [0] * i, crc.CRC16_POLY, 16)
    p8 = seal_cuda.p8_table()
    rng = np.random.default_rng(8)
    for n in (0, 1, 5, 15, 40):
        msg = rng.integers(0, 256, n)
        acc = 0
        for i, byte in enumerate(msg):
            for k in range(8):
                if (byte >> k) & 1:
                    acc ^= int(p8[(8 * (n - 1 - i) + 8 + k) % seal_cuda.P8_LEN])
        assert acc == _crc_bits(msg, crc.CRC8_POLY, 8) == crc.crc8(msg)


@pytest.mark.parametrize("level", range(seal_cuda.LEVELS))
def test_k5_level_tables_append_zero_bytes(level):
    """row0[r & 0xFF] ^ row1[r >> 8] of level l is r x^(64 2^l): the CRC of
    A followed by B (8 2^l bytes) from the CRCs of A and B."""
    tab = seal_cuda.level_tables()[level]
    rng = np.random.default_rng(level)
    for _ in range(2):
        a = rng.integers(0, 256, int(rng.integers(1, 40)))
        b = rng.integers(0, 256, 8 << level)
        ra = _crc_bits(a, crc.CRC16_POLY, 16)
        assert (int(tab[0, ra & 0xFF]) ^ int(tab[1, ra >> 8])
                ^ crc.crc16(b)) == crc.crc16(np.r_[a, b])


def _mirror_seal(words, byte_len, hdr_bytes, nc):
    """csrc/frame_crc.cu's arithmetic in numpy at cluster size nc: the
    whole 8-byte pairs end-aligned over T = 256 nc columns, each column's
    Horner by x^(64 T), the tree by x^(64 2^l), the ranks by x^(64 256),
    the partial pair and the zeros past the row once, the CRC-8 from its
    bit table folded into its word."""
    sl = seal_cuda.slicing_tables().astype(np.int64)
    lv = seal_cuda.level_tables().astype(np.int64)
    p8 = seal_cuda.p8_table()
    pw = crc.byte_shift_powers(crc.CRC16_POLY, 16, seal_cuda.POW_TERMS)
    lx = 8 + nc.bit_length() - 1
    T = 1 << lx
    out = np.array(words, np.int64)
    W = out.shape[1]

    def mul(lvl, r):
        return lv[lvl, 0, r & 0xFF] ^ lv[lvl, 1, r >> 8]

    def deposit(w, idx, value):
        return (w + (int(value) << (3 - (idx & 3)) * 8)) & 0xFFFFFFFF

    for b in range(out.shape[0]):
        row, hb, bl = out[b].copy(), int(hdr_bytes[b]), int(byte_len[b])
        raw = np.stack([(row >> s) & 0xFF for s in (24, 16, 8, 0)],
                       -1).reshape(-1)
        c8 = 0
        for i in range(min(max(hb, 0), 4 * W)):
            for k in range(8):
                if (raw[i] >> k) & 1:
                    c8 ^= int(p8[(8 * (hb - 1 - i) + 8 + k)
                                 % seal_cuda.P8_LEN])
        words_in = row.copy()                      # as the CRC-16 reads them
        if hb >= 0 and hb >> 2 < W:
            words_in[hb >> 2] = deposit(words_in[hb >> 2], hb, c8)
        L = max(bl - 2, 0)
        inrow = min(L, 4 * W)
        Q = inrow >> 3
        K = -(-Q // T)
        off = K * T - Q
        hi, lo = words_in[0:2 * Q:2], words_in[1:2 * Q:2]
        pc = sl[7][hi >> 24] ^ sl[6][(hi >> 16) & 0xFF] ^ sl[5][(hi >> 8) & 0xFF] \
            ^ sl[4][hi & 0xFF] ^ sl[3][lo >> 24] ^ sl[2][(lo >> 16) & 0xFF] \
            ^ sl[1][(lo >> 8) & 0xFF] ^ sl[0][lo & 0xFF]
        virt = np.r_[np.zeros(off, np.int64), pc].reshape(K, T)
        H = np.zeros(T, np.int64)
        for k in range(K):
            H = mul(lx, H) ^ virt[k]
        for lvl in range(8):
            H = mul(lvl, H[0::2]) ^ H[1::2]
        r = 0
        for q in range(nc):
            r = int(mul(8, r)) ^ int(H[q])
        n = inrow - 8 * Q
        tail = [(int(words_in[2 * Q + (k >> 2)]) >> (24 - 8 * (k & 3))) & 0xFF
                if 2 * Q + (k >> 2) < W else 0 for k in range(n)]
        if n:
            tail[0] ^= r >> 8
            acc = 0 if n >= 2 else (r & 0xFF) << 8
            if n >= 2:
                tail[1] ^= r & 0xFF
            for j in range(n):
                acc ^= int(sl[n - 1 - j][tail[j]])
            r = acc
        after = L - inrow
        for i in range(seal_cuda.POW_TERMS):
            if (after >> i) & 1:
                r = crc.mulmod(r, int(pw[i]), crc.CRC16_POLY, 16)
        for idx, value in ((hb, c8), (bl - 2, r >> 8), (bl - 1, r & 0xFF)):
            if idx >= 0 and idx >> 2 < W:
                row[idx >> 2] = deposit(row[idx >> 2], idx, value)
        out[b] = row
    return out


@pytest.mark.parametrize("nc", [1, 2, 4, 8])
def test_k5_arithmetic_mirror_matches_the_host_seal(nc):
    for label, case in SEAL:
        if case["words"].shape[1] > 64:
            continue
        got = _mirror_seal(case["words"], case["byte_len"],
                           case["hdr_bytes"], nc)
        want = assemble_synth.seal_host(case["words"], case["byte_len"],
                                        case["hdr_bytes"])
        np.testing.assert_array_equal(got, want, label)


def test_k5_cluster_size_mirrors_the_source():
    """seal_cuda's constants and cluster_size follow the source; the host
    table's image is the size of the kernel's shared-memory image."""
    src = (Path(seal_cuda.__file__).parents[1] / "csrc"
           / "frame_crc.cu").read_text()
    for name in ("CLUSTER", "CTA_TARGET", "POW_TERMS", "LEVELS", "P8_LEN"):
        assert f"constexpr int {name} = {getattr(seal_cuda, name)};" in src
    assert "while (nc > 1 && (long long)B * nc > CTA_TARGET) nc >>= 1;" \
        in src
    assert {B: seal_cuda.cluster_size(B) for B in (1, 16, 17, 66, 67, 256)} \
        == {1: 8, 16: 8, 17: 4, 66: 2, 67: 1, 256: 1}
    image = (len(seal_cuda.host_tables()) - 512 - seal_cuda.POW_TERMS) * 4
    assert image == 8 * 256 * 2 + 128 + seal_cuda.LEVELS * 2 * 256 * 2
