"""Stereo decorrelation search and wasted-bits analysis.

Port of flac_tpu/models/stereo.py (the reference's process_subframes_,
stream_encoder.c:3747-3971): build the four channel candidates (left,
right, mid, side), compute wasted bits per candidate, and after the
subframe search pick the channel assignment with the smallest total.
"""

from __future__ import annotations

import torch

from ..config import EncoderConfig
from ..device import constant
from ..ops.bitops import bit_length, or_reduce

# channel-candidate indices on the CH axis
L, R, M, S = 0, 1, 2, 3

# per-assignment (ch0, ch1) candidate indices
# (frame_add_header channel codes: independent / left-side / right-side /
#  mid-side, stream_encoder_framing.c:320-345)
_ASSIGN_CH0 = (L, L, S, M)
_ASSIGN_CH1 = (R, S, R, S)


def wasted_bits(x):
    """Common trailing-zero count over each subframe's samples
    (get_wasted_bits_, stream_encoder.c:5077-5100): 0 when the signal is
    all-zero, else ctz of the OR of all samples.  x: [..., N] holding
    int32 values."""
    acc = or_reduce(x.to(torch.int64))
    low = (acc & -acc) & 0xFFFFFFFF          # lowest set bit (as uint32)
    ctz = bit_length(low) - 1
    return torch.where(acc != 0, ctz, 0).to(torch.int32)


def _channel_bps(bps: int, C: int, mid_side: bool,
                 device) -> torch.Tensor:
    """[1, CH] int32 bits per sample of each channel candidate: bps for
    each of the C channels, or [bps, bps, bps, bps + 1] for L, R, M, S."""
    row = [bps, bps, bps, bps + 1] if mid_side else [bps] * C
    return constant(("channel bps", tuple(row)), device,
                    lambda dev: torch.tensor([row], dtype=torch.int32,
                                             device=dev))


def build_channel_candidates(pcm, cfg: EncoderConfig):
    """pcm [B, C, N] int32 -> (candidate signals, per-candidate bps, wasted).

    For stereo with mid-side search: [B, 4, N] (L, R, M, S), bps
    [bps, bps, bps, bps+1]; otherwise the channels pass through.
    mid = (L+R)>>1 (arithmetic), side = L-R (stream_encoder.c:3823-3836).

    At bps=32 the side channel is 33-bit (integer_signal_33bit_side,
    stream_encoder.c:152,3823-3836): the candidates are int64, which holds
    it exactly (the reference uses f64 only to keep the TPU off its x64
    rewrite), and the wasted-bit count comes from the int32 wrap of each
    candidate, as the reference's does.
    """
    B, C, N = pcm.shape
    bps = cfg.bits_per_sample
    if C == 2 and cfg.do_mid_side and cfg.max_subframe_bps > 32:
        left = pcm[:, 0].to(torch.int64)
        right = pcm[:, 1].to(torch.int64)
        x = torch.stack([left, right, (left + right) >> 1, left - right],
                        dim=1)
        # ctz over the int32 wrap; a channel whose low 32 bits OR to zero
        # but which holds nonzero +-2^32 values gets 32
        x_lo = ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        w = wasted_bits(x_lo)
        lo_zero = or_reduce(x_lo) == 0
        w = torch.where(lo_zero & (x != 0).any(dim=-1), 32, w)
        bps_eff = _channel_bps(bps, C, True, pcm.device) - w
        return x >> w[..., None], bps_eff, w
    if C == 2 and cfg.do_mid_side:
        left = pcm[:, 0]
        right = pcm[:, 1]
        mid = (left + right) >> 1
        side = left - right
        x = torch.stack([left, right, mid, side], dim=1)
    else:
        x = pcm
    w = wasted_bits(x)                       # [B, CH]
    x_shifted = x >> w[..., None]
    bps_eff = _channel_bps(bps, C, C == 2 and cfg.do_mid_side,
                           pcm.device) - w
    return x_shifted, bps_eff, w


def loose_assignment(pcm, cfg: EncoderConfig):
    """Loose mid-side heuristic (stream_encoder.c:3777-3812): pick
    INDEPENDENT vs MID_SIDE per frame from first-difference abs sums.
    Exact f64 sums stand in for the reference's int64 accumulators."""
    dL = (pcm[:, 0, 1:] - pcm[:, 0, :-1]).to(torch.float64)
    dR = (pcm[:, 1, 1:] - pcm[:, 1, :-1]).to(torch.float64)
    sum_lr = (dL.abs() + dR.abs()).sum(dim=-1)
    sum_ms = (torch.floor((dL + dR) / 2).abs() + (dL - dR).abs()).sum(dim=-1)
    assignment = torch.where(sum_lr < sum_ms, 0, 3).to(torch.int32)
    ch0 = torch.where(assignment == 0, L, M).to(torch.int32)
    ch1 = torch.where(assignment == 0, R, S).to(torch.int32)
    return assignment, torch.stack([ch0, ch1], dim=1)


def select_assignment(bits, cfg: EncoderConfig):
    """Choose the channel assignment minimizing total bits.

    bits: [B, 4] best subframe bits per candidate (L, R, M, S).
    Returns (assignment [B] int32, ch_index [B, 2] int32) where ch_index
    maps output channel slots to candidate rows.  First index wins ties,
    as in the 4-way argmin at stream_encoder.c:3944-3971.
    """
    totals = torch.stack([
        bits[:, L] + bits[:, R],     # independent
        bits[:, L] + bits[:, S],     # left-side
        bits[:, R] + bits[:, S],     # right-side
        bits[:, M] + bits[:, S],     # mid-side
    ], dim=1)
    assignment = totals.argmin(dim=1).to(torch.int32)
    table = constant("assignment channels", bits.device,
                     lambda dev: torch.tensor([_ASSIGN_CH0, _ASSIGN_CH1],
                                              dtype=torch.int32,
                                              device=dev).T)   # [4, 2]
    return assignment, table[assignment.long()]


def _pick(a, ch_index):
    idx = ch_index.long()
    while idx.ndim < a.ndim:
        idx = idx[..., None]
    idx = idx.expand((a.shape[0], ch_index.shape[1]) + tuple(a.shape[2:]))
    return torch.gather(a, 1, idx)


def gather_channels(choice, ch_index):
    """Select the winning channel candidates along axis 1.

    choice:   a tensor, or a tuple or NamedTuple (SubframeChoice) of
              tensors, with axis 1 = CH (4 candidates); each keeps its
              dtype (the 33-bit candidates stay int64)
    ch_index: [B, C_out] int32
    Returns the same structure with axis 1 = C_out.
    """
    if isinstance(choice, torch.Tensor):
        return _pick(choice, ch_index)
    picked = [_pick(a, ch_index) for a in choice]
    return choice._make(picked) if hasattr(choice, "_make") else tuple(picked)
