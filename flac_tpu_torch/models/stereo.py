"""Stereo decorrelation search and wasted-bits analysis.

Port of flac_tpu/models/stereo.py (the reference's process_subframes_,
stream_encoder.c:3747-3971): build the four channel candidates (left,
right, mid, side), compute wasted bits per candidate, and after the
subframe search pick the channel assignment with the smallest total.

On a CUDA device the two stages are hand-written kernels: the candidates
(build_channel_candidates: K10, ops/candidates_cuda.py) and the
assignment with its gathers (assign_channels: K12, ops/assign_cuda.py);
their plain versions (build_channel_candidates_plain, loose_assignment,
assign_channels_plain) run on the CPU.
"""

from __future__ import annotations

import torch

from .. import format as fmt
from ..config import EncoderConfig
from ..device import constant
from ..ops import assign_cuda, candidates_cuda
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
    """pcm [B, C, N] int16 or int32 -> (candidate signals, per-candidate
    bps, wasted), and on the loose mid-side path (stereo, do_mid_side and
    loose_mid_side) the loose assignment [B] int32 after them (0
    independent, 3 mid-side: loose_assignment's).

    Dispatches on pcm's device: the plain versions for a CPU tensor,
    kernel K10 (ops/candidates_cuda.py) for a CUDA tensor (it launches or
    raises; there is no fallback).
    """
    if pcm.device.type == "cuda":
        return candidates_cuda.channel_candidates(pcm, cfg)
    out = build_channel_candidates_plain(pcm, cfg)
    if candidates_cuda.forms(pcm.shape[1], cfg)[2]:
        out += (loose_assignment(pcm.to(torch.int32), cfg)[0],)
    return out


def build_channel_candidates_plain(pcm, cfg: EncoderConfig):
    """pcm [B, C, N] int16 or int32 -> (candidate signals, per-candidate
    bps, wasted), op by op (K10's plain version).

    For stereo with mid-side search: [B, 4, N] (L, R, M, S), bps
    [bps, bps, bps, bps+1]; otherwise the channels pass through.
    mid = (L+R)>>1 (arithmetic), side = L-R (stream_encoder.c:3823-3836).

    At bps=32 the side channel is 33-bit (integer_signal_33bit_side,
    stream_encoder.c:152,3823-3836): the candidates are int64, which holds
    it exactly (the reference uses f64 only to keep the TPU off its x64
    rewrite), and the wasted-bit count comes from the int32 wrap of each
    candidate, as the reference's does.
    """
    pcm = pcm.to(torch.int32)
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
    return assignment, _assignment_table(bits.device)[assignment.long()]


def _assignment_table(device) -> torch.Tensor:
    """[4, 2] int32: each assignment's (ch0, ch1) candidate rows."""
    return constant("assignment channels", device,
                    lambda dev: torch.tensor([_ASSIGN_CH0, _ASSIGN_CH1],
                                             dtype=torch.int32,
                                             device=dev).T)


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


def assign_channels(choice, x, loose, cfg: EncoderConfig, mid_side: bool):
    """The channel assignment of every frame, the chosen candidates'
    subframes and signals, and the limit_min_bitrate rule
    (flac_tpu/encoder.py:62-80).

    choice: the SubframeChoice of every channel candidate ([B, CH, ...])
    x:      [B, CH, N] candidate signals (int32, or int64 on the 33-bit
            side)
    loose:  [B] int32 loose assignment (build_channel_candidates' fourth
            output) on the loose mid-side path, else None
    mid_side: the candidates are L, R, M, S (stereo with the mid-side
            search), else they are the channels
    Returns (assignment [B] int32, the SubframeChoice and the signal
    [B, C, N] of the stream's channels).

    On the stereo mid-side path it dispatches on x's device: the plain
    version for a CPU tensor, kernel K12 (ops/assign_cuda.py) for a CUDA
    tensor (it launches or raises; there is no fallback).  Elsewhere the
    candidates are the channels: an assignment of zeros and the
    limit_min_bitrate rule (_pass_channels).
    """
    if not mid_side:
        return _pass_channels(choice, x, cfg)
    if x.device.type == "cuda":
        assignment, *fields, signal = assign_cuda.assign_channels(
            choice, x, loose, cfg.limit_min_bitrate)
        return assignment, choice._make(fields), signal
    return assign_channels_plain(choice, x, loose, cfg)


def _limit_min_bitrate(choice, cfg: EncoderConfig):
    """Force the last subframe of an all-constant frame to verbatim so
    that frames never shrink to a few bytes (stream_encoder.c:3874-3879)."""
    if not cfg.limit_min_bitrate:
        return choice
    all_const = (choice.type_ == fmt.SUBFRAME_TYPE_CONSTANT).all(dim=1)
    new_type = choice.type_.clone()
    new_type[:, -1] = torch.where(
        all_const, fmt.SUBFRAME_TYPE_VERBATIM, choice.type_[:, -1])
    return choice._replace(type_=new_type)


def _pass_channels(choice, x, cfg: EncoderConfig):
    """assign_channels where there is no mid-side search."""
    assignment = torch.zeros((x.shape[0],), dtype=torch.int32,
                             device=x.device)
    return assignment, _limit_min_bitrate(choice, cfg), x


def assign_channels_plain(choice, x, loose, cfg: EncoderConfig):
    """assign_channels on the stereo mid-side path, op by op (K12's plain
    version): the loose assignment or select_assignment's argmin, both
    gather_channels, the limit_min_bitrate rule."""
    if loose is not None:
        assignment = loose
        ch_index = _assignment_table(x.device)[loose.long()]
    else:
        assignment, ch_index = select_assignment(choice.bits, cfg)
    choice = gather_channels(choice, ch_index)
    return assignment, _limit_min_bitrate(choice, cfg), \
        gather_channels(x, ch_index)
