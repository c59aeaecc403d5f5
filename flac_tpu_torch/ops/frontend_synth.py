"""Synthetic inputs for the encoder's front and back of the search, made
from a seed with numpy: K10 (the channel candidates,
csrc/channel_candidates.cu), K11 (the windowed autocorrelation,
csrc/window_autoc.cu) and K12 (the channel assignment,
csrc/assign_channels.cu).

Each case pins a corner of the plain versions (models/stereo.py
build_channel_candidates_plain and loose_assignment, ops/lpc.py
autocorrelation_plain, models/stereo.py assign_channels_plain) that the
encoder's real batches rarely reach.

K10 (`candidate_cases`): 16-bit stereo uploaded as int16 and as int32,
a batch whose first frames hold an all-zero channel, wasted bits on one
candidate only (L a multiple of 4, R = 3 mod 4), a side of zeros (L = R),
a constant frame and full-scale samples; the 33-bit side (bps 32: side
rows past 2^31, a side of +-2^31 whose low 31 bits are zero; a row whose
low 32 bits are all zero but which is not zero cannot come from int32
samples, so the rule that gives it 32 is held by the code alone); the
loose path at -1 and -4 (near-mono and independent frames, both
assignments) and at 32 bits (first differences that wrap int32); the
channels passing through (mono 24-bit, 6 channels at 20 bits, -0);
N of 1, 33, 200, 1153, 4048, 4095, 4096, 8192 stereo and 16384 mono
(several steps a lane) and 32768 mono (a part of the frame too large to
keep in shared memory); for the two CTAs' parts of a frame
(candidates_cuda.share), frames whose only odd sample (of L; of R a
sample 2 mod 4) opens or closes a part, so that the wasted bits of both
parts come from one part alone, and loose frames whose one large first
difference is the first of a part, across its boundary (it decides the
assignment).

K11 (`autoc_cases`): the -5 bank (one window, lags to 8) and the -8 bank
(subdivide_tukey(3): 6 windows, 9 apodizations, lags to 12) at N = 4096;
N = 4048 and N = 200 (no multiple of 128); the largest lag N - 1 (N = 9
with 8 lags, N = 33 with 32); N = 4097 and 8192 (a second tile, the halo
across it, of 12 lags and of 9); silence and a constant row; 16-bit,
24-bit and full-scale 32-bit rows and the 33-bit side's int64 rows; for
the skipped zero blocks, a -8 row silent over its first half (but three
lone samples, none a lane's first of four), a bank with
punchout_tukey windows (a zero hole inside the row) and the -8 bank at
N = 1000 (partial windows that start and end inside a block of 128); and
order 32 at N = 4096 (-l 32: the template of 32 at full width).  One
window takes a kernel of its own (a CTA a row), so the -5 bank also has
a row silent over its first half, the 33-bit side's int64 rows and order
32 at N = 4096.

K12 (`assign_cases`): random subframe choices of the four candidates
with small bit counts (many exact ties: all four totals equal, L + S
equal to M + S), frames whose every candidate is CONSTANT under
limit_min_bitrate (channel 1 becomes VERBATIM) and frames where only one
chosen channel is CONSTANT, the loose path's given assignments, int64
signals and warm-ups (the 33-bit side), N of 33 (the rows copied a value
at a time), 200, 4048 and 4096, P of 1 to 64.

chip_smoke.py and the card-only tests hold K10-K12 against their plain
versions on them; the CPU tests hold the plain versions against
flac_tpu's on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..config import EncoderConfig
from ..models.subframe import SubframeChoice
from . import candidates_cuda
from . import lpc as lpc_ops


def _config(level: int, N: int, bps: int = 16, channels: int = 2,
            **kw) -> EncoderConfig:
    return EncoderConfig.from_preset(level, blocksize=N, bits_per_sample=bps,
                                     channels=channels, **kw).resolve()


def _music(rng, shape, bps: int) -> np.ndarray:
    """Smooth signals with noise, within bps bits (int64)."""
    *lead, N = shape
    t = np.arange(N)
    amp = (1 << (bps - 1)) * 0.6
    f = rng.uniform(0.002, 0.05, tuple(lead) + (1,))
    ph = rng.uniform(0, 2 * np.pi, tuple(lead) + (1,))
    sig = amp * np.sin(2 * np.pi * f * t + ph)
    sig += rng.normal(0, amp * 0.01, tuple(lead) + (N,))
    lim = (1 << (bps - 1))
    return np.clip(np.round(sig), -lim, lim - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# K10: the channel candidates
# ---------------------------------------------------------------------------

def candidate_batch(seed: int, *, B: int, C: int, N: int, bps: int,
                    corners: bool = True) -> np.ndarray:
    """[B, C, N] int64 samples of bps bits; with `corners` (stereo) the
    first frames pin the corners named in the module docstring."""
    rng = np.random.default_rng(seed)
    pcm = _music(rng, (B, C, N), bps)
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    if corners and C == 2 and B >= 5:
        pcm[0, 0] = 0                                    # an all-zero L
        a = rng.integers(lo // 4, hi // 4, N)
        b = rng.integers(lo // 4, hi // 4 - 1, N)
        pcm[1, 0], pcm[1, 1] = 4 * a, 4 * b + 3     # wasted bits on L only
        pcm[2, 1] = pcm[2, 0]                            # a side of zeros
        pcm[3] = rng.integers(lo, hi)                    # a constant frame
        pcm[4] = rng.choice([lo, hi, 0, -1], (C, N))     # full scale
    return pcm


def candidate_cases() -> list:
    """(label, {"pcm": [B, C, N] int16 or int32, "cfg"}); the loose
    cases' configurations have loose_mid_side."""
    out = []

    def add(label, pcm, cfg, dtype):
        out.append((label, {"pcm": pcm.astype(dtype), "cfg": cfg}))

    p16 = candidate_batch(1, B=8, C=2, N=4096, bps=16)
    add("-5, 16-bit, int16 upload, N=4096", p16, _config(5, 4096), np.int16)
    add("-5, 16-bit, int32 upload, N=4096", p16, _config(5, 4096), np.int32)
    add("-5, 16-bit, N=4048", candidate_batch(2, B=6, C=2, N=4048, bps=16),
        _config(5, 4048), np.int16)
    add("-5, 16-bit, N=200", candidate_batch(3, B=6, C=2, N=200, bps=16),
        _config(5, 200), np.int16)
    add("-5, 16-bit, N=1153", candidate_batch(4, B=6, C=2, N=1153, bps=16),
        _config(5, 1153), np.int32)
    add("-5, 16-bit, N=1", candidate_batch(5, B=3, C=2, N=1, bps=16,
                                            corners=False),
        _config(5, 1), np.int16)
    add("-5, 16-bit, N=8192 (rows read again)",
        candidate_batch(6, B=5, C=2, N=8192, bps=16), _config(5, 8192),
        np.int16)
    # the 33-bit side: side rows past 2^31, and a side of +-2^31
    p32 = candidate_batch(7, B=6, C=2, N=4095, bps=32)
    p32[5, 0] = -(1 << 31)
    p32[5, 1] = np.where(np.arange(4095) % 3, 0, -(1 << 31))
    add("33-bit side, N=4095", p32, _config(5, 4095, bps=32), np.int32)
    p33 = candidate_batch(8, B=5, C=2, N=4096, bps=32)
    p33[:, 1] = -p33[:, 0] - 1                          # |side| near 2^32
    add("33-bit side, antiphase, N=4096", p33, _config(5, 4096, bps=32),
        np.int32)
    # the loose path: near-mono frames and independent ones
    pl = candidate_batch(9, B=8, C=2, N=1152, bps=16, corners=False)
    rng = np.random.default_rng(10)
    pl[:4, 1] = np.clip(pl[:4, 0] + rng.integers(-3, 4, (4, 1152)),
                        -32768, 32767)
    add("-1 loose, 16-bit, N=1152", pl, _config(1, 1152), np.int16)
    add("-4 loose, 16-bit, N=1152", pl, _config(4, 1152), np.int32)
    pw = candidate_batch(11, B=6, C=2, N=200, bps=32)
    pw[0, 0] = np.where(np.arange(200) % 2, -(1 << 31), (1 << 31) - 1)
    add("-4 loose, 32-bit (wrapping differences), N=200", pw,
        _config(4, 200, bps=32), np.int32)
    # the channels pass through
    add("mono 24-bit, N=4096", candidate_batch(12, B=4, C=1, N=4096,
                                                bps=24),
        _config(5, 4096, bps=24, channels=1), np.int32)
    add("6 channels 20-bit, N=33", candidate_batch(13, B=3, C=6, N=33,
                                                    bps=20),
        _config(5, 33, bps=20, channels=6), np.int32)
    p0 = candidate_batch(14, B=6, C=2, N=4096, bps=16)
    add("-0 (no mid-side), int16, N=4096", p0, _config(0, 4096), np.int16)
    add("mono 16-bit, N=16384 (rows read again)",
        candidate_batch(15, B=2, C=1, N=16384, bps=16),
        _config(5, 16384, channels=1), np.int16)
    # a part past STAGE_BYTES (candidates_cuda.staged): its rows read again
    add("mono 16-bit, N=32768 (a part's rows read again)",
        candidate_batch(17, B=1, C=1, N=32768, bps=16),
        _config(5, 32768, channels=1), np.int16)
    # as many frames as an H100 has SMs and more: one CTA a frame
    # (candidates_cuda.split)
    add("-5, 140 frames of 64 (one CTA a frame)",
        candidate_batch(18, B=140, C=2, N=64, bps=16), _config(5, 64),
        np.int16)
    # the CTAs' parts of a frame (candidates_cuda.share: the second starts
    # at s; a "rank's share" is a part): L's only odd sample and R's only
    # sample 2 mod 4 open a part (s, 0) or close one (s - 1, N - 1), so
    # that the other CTA's writes hang on a sample of this part
    rng = np.random.default_rng(16)
    po = np.stack([2 * rng.integers(-8000, 8000, (2, 4096)),
                   4 * rng.integers(-4000, 4000, (2, 4096))], axis=1)
    s = candidates_cuda.share(4096, candidates_cuda.SPLIT)
    po[0, 0, s] += 1
    po[0, 1, 0] += 2
    po[1, 0, s - 1] += 1
    po[1, 1, 4095] += 2
    add("-5, wasted bits from one rank's share, N=4096", po,
        _config(5, 4096), np.int16)
    # loose frames whose one nonzero first difference is at the second
    # part's first sample (it reads the first part's last): it alone
    # decides the frame
    pb = np.zeros((3, 2, 1152), np.int64)
    s = candidates_cuda.share(1152, candidates_cuda.SPLIT)
    pb[0, 0, s:] = 1000
    pb[1, 1, s:] = -700
    pb[2, 0, s:] = 30000
    pb[2, 1, s:] = -30000
    add("-4 loose, a first difference across a share boundary, N=1152", pb,
        _config(4, 1152), np.int16)
    return out


def as_candidate_inputs(case: dict, device) -> tuple:
    """(pcm, cfg) of a candidate case on `device`."""
    return torch.from_numpy(case["pcm"]).to(device), case["cfg"]


# ---------------------------------------------------------------------------
# K11: the windowed autocorrelation
# ---------------------------------------------------------------------------

def autoc_batch(seed: int, *, B: int, CH: int, N: int, bps: int,
                x64: bool = False) -> np.ndarray:
    """[B, CH, N] signal rows of bps bits, the first silent and the
    second constant."""
    rng = np.random.default_rng(seed)
    x = _music(rng, (B, CH, N), bps)
    x[0, 0] = 0
    if B * CH > 1:
        x.reshape(B * CH, N)[1] = rng.integers(-(1 << (bps - 2)),
                                               1 << (bps - 2))
    return x.astype(np.int64 if x64 else np.int32)


def autoc_cases() -> list:
    """(label, {"x", "windows", "combine", "O"}): windows [W, N] float32
    and combine [A, W] float32 as an ApodizationBank holds them."""
    out = []

    def add(label, x, level, N, O=None, **kw):
        cfg = _config(level, N, **kw)
        bank = lpc_ops.build_apodization_bank(N, cfg.apodizations)
        out.append((label, {"x": x, "windows": bank.windows,
                            "combine": bank.combine,
                            "O": min(cfg.max_lpc_order, N - 1)
                            if O is None else O}))

    add("-5, 16-bit, N=4096", autoc_batch(20, B=4, CH=4, N=4096, bps=17),
        5, 4096)
    add("-8, 16-bit, N=4096 (6 windows, 9 apodizations)",
        autoc_batch(21, B=2, CH=4, N=4096, bps=17), 8, 4096)
    add("-5, N=4048", autoc_batch(22, B=2, CH=4, N=4048, bps=17), 5, 4048)
    add("-8, N=200", autoc_batch(23, B=2, CH=4, N=200, bps=17), 8, 200)
    add("-5, N=9, lags to N - 1", autoc_batch(24, B=2, CH=4, N=9, bps=16),
        5, 9)
    add("-8 -l 32, N=33, lags to N - 1 = 32",
        autoc_batch(25, B=2, CH=2, N=33, bps=16), 8, 33,
        max_lpc_order=32)
    add("-8, N=4097 (a second tile)", autoc_batch(26, B=1, CH=4, N=4097,
                                                   bps=17), 8, 4097)
    add("-7, N=8192 (two tiles)", autoc_batch(27, B=1, CH=2, N=8192,
                                               bps=24), 7, 8192)
    add("-5 -l 9, N=8192 (two tiles, a halo of 9)",
        autoc_batch(31, B=1, CH=2, N=8192, bps=17), 5, 8192,
        max_lpc_order=9)
    add("-5, 24-bit, N=1152", autoc_batch(28, B=2, CH=4, N=1152, bps=25),
        5, 1152, bps=24)
    add("-5, full-scale 32-bit, N=1152",
        autoc_batch(29, B=2, CH=2, N=1152, bps=32), 5, 1152, bps=32)
    add("-8, 33-bit side (int64), N=1152",
        autoc_batch(30, B=2, CH=4, N=1152, bps=33, x64=True), 8, 1152,
        bps=32)
    # the blocks whose windowed samples are all zero (skipped)
    xh = autoc_batch(32, B=1, CH=2, N=4096, bps=17)
    xh[0, 1, :2048] = 0
    xh[0, 1, [131, 518, 1027]] = [5000, -7000, 3]    # lone samples
    add("-8, a row silent over its first half, N=4096", xh, 8, 4096)
    add("-5, punchout_tukey(3) (a zero hole), N=4096",
        autoc_batch(33, B=1, CH=2, N=4096, bps=17), 5, 4096,
        apodizations=("tukey(5e-1)", "punchout_tukey(3)"))
    add("-8, N=1000 (partial windows inside a block)",
        autoc_batch(34, B=1, CH=2, N=1000, bps=17), 8, 1000)
    add("-8 -l 32, N=4096 (the template of 32)",
        autoc_batch(35, B=1, CH=2, N=4096, bps=17), 8, 4096,
        max_lpc_order=32)
    # one window (a CTA a row): zero blocks in a live tile (summed), the
    # 33-bit side's int64 rows, the template of 32
    add("-5, a row silent over its first half, N=4096", xh, 5, 4096)
    add("-5, 33-bit side (int64), N=1152",
        autoc_batch(36, B=2, CH=4, N=1152, bps=33, x64=True), 5, 1152,
        bps=32)
    add("-5 -l 32, N=4096 (one window, the template of 32)",
        autoc_batch(37, B=1, CH=2, N=4096, bps=17), 5, 4096,
        max_lpc_order=32)
    return out


def as_autoc_inputs(case: dict, device) -> tuple:
    """(x, windows, combine float64, O) of an autocorrelation case on
    `device`, as search_and_realize hands them to window_autocorrelation."""
    return (torch.from_numpy(case["x"]).to(device),
            torch.from_numpy(case["windows"]).to(device),
            torch.from_numpy(case["combine"]).to(device, torch.float64),
            case["O"])


# ---------------------------------------------------------------------------
# K12: the channel assignment
# ---------------------------------------------------------------------------

def assign_batch(seed: int, *, B: int, N: int, P: int, x64: bool = False,
                 bits_max: int = 4) -> dict:
    """Random SubframeChoice fields of the four candidates ([B, 4, ...])
    and their signals x; bits below bits_max (many exact ties).  Frames 0
    and 1 have every candidate CONSTANT, frame 2 only L and R."""
    rng = np.random.default_rng(seed)
    xt = np.int64 if x64 else np.int32
    big = (1 << 33) if x64 else (1 << 30)

    def ints(*shape, lo=-1000, hi=1000):
        return rng.integers(lo, hi, (B, 4) + shape).astype(np.int32)
    c = {"bits": ints(lo=0, hi=bits_max),
         "type_": ints(lo=0, hi=4), "order": ints(lo=0, hi=33),
         "wasted": ints(lo=0, hi=4), "bps_eff": ints(lo=1, hi=34),
         "qcoeffs": ints(fmt.MAX_LPC_ORDER),
         "shift": ints(lo=0, hi=16), "precision": ints(lo=0, hi=16),
         "warmup": rng.integers(-big, big, (B, 4, fmt.MAX_LPC_ORDER)
                                ).astype(xt),
         "residual": ints(N, lo=-(1 << 20), hi=1 << 20),
         "po": ints(lo=0, hi=7), "params": ints(P, lo=0, hi=31),
         "use_rice2": rng.integers(0, 2, (B, 4)).astype(bool)}
    c["type_"][:2] = fmt.SUBFRAME_TYPE_CONSTANT
    if B > 2:
        c["type_"][2, :2] = fmt.SUBFRAME_TYPE_CONSTANT
        c["type_"][2, 2:] = fmt.SUBFRAME_TYPE_LPC
    x = rng.integers(-big, big, (B, 4, N)).astype(xt)
    return {"choice": c, "x": x}


def assign_cases() -> list:
    """(label, {"choice": fields, "x", "loose": [B] int32 or None,
    "limit_min_bitrate"})."""
    out = []

    def add(label, batch, loose=None, limit=False):
        out.append((label, {**batch, "loose": loose,
                            "limit_min_bitrate": limit}))

    add("ties, N=4096, P=32", assign_batch(40, B=64, N=4096, P=32))
    add("ties, limit_min_bitrate, N=4096, P=32",
        assign_batch(41, B=16, N=4096, P=32), limit=True)
    b = assign_batch(42, B=8, N=4048, P=16)
    b["choice"]["bits"][:] = 7                        # all four totals equal
    b["choice"]["bits"][4:, 0] = b["choice"]["bits"][4:, 2] = 3  # L+S = M+S
    b["choice"]["bits"][4:, 1] = 9                    # ... below L + R
    add("equal totals, L + S = M + S, N=4048", b)
    rng = np.random.default_rng(43)
    add("loose, limit_min_bitrate, N=200, P=1",
        assign_batch(43, B=8, N=200, P=1),
        loose=rng.choice([0, 3], 8).astype(np.int32), limit=True)
    add("33-bit side (int64), N=33 (a value at a time), P=64",
        assign_batch(44, B=6, N=33, P=64, x64=True), limit=True)
    add("33-bit side, loose, N=4096, P=32",
        assign_batch(45, B=4, N=4096, P=32, x64=True, bits_max=1 << 20),
        loose=np.array([3, 0, 0, 3], np.int32))
    return out


def as_assign_inputs(case: dict, device) -> tuple:
    """(choice, x, loose) of an assignment case on `device`."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    choice = SubframeChoice(**{k: t(v) for k, v in case["choice"].items()})
    loose = None if case["loose"] is None else t(case["loose"])
    return choice, t(case["x"]), loose
