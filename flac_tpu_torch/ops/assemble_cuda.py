"""Kernel K4: the encoder's frame field lists as a hand-written CUDA kernel.

Replaces the field-list build of flac_tpu/models/frame.py:assemble_frames
(:70-377, with `_utf8_fields` and the padding), which XLA fuses into a few
programs on the TPU and the port ran op by op: about 2300 small kernels a
-5 batch of 64 frames.  The source is csrc/assemble_fields.cu: a thread
block cluster of up to 8 CTAs a frame (`cluster_size(B)`: 8 at B=64, 2 at
B=256), each rank a share of the frame's field slots, each slot computed
from the frame's subframe choice on its own; the frame's bit total and
the quad layout's fit flag are warp and CTA reductions whose shares meet
in rank 0's shared memory (see the source for the design).

A frame's fields follow one static layout, `field_layout(C, N, P, quad,
wide)`: the frame header, 7 UTF-8 slots, the blocksize and rate tails and
the CRC-8 slot; for each channel its type byte, wasted-bits unary, 32
warm-up slots (64, as (high, low-16) pairs, when wide), LPC precision and
shift, 32 coefficients, method and partition order, partition 0's
parameter prefix, then G groups of a parameter prefix and `per` sample
slots; then the padding and the CRC-16 slot.  The plain version,
models/frame.py:assemble_fields_plain, builds the same list by
concatenation; tests/test_torch_assemble.py holds the two lists' counts
and segment offsets equal for every layout.

Bound: per -5 batch (B=64, C=2, N=4096, F=2263 fields) the kernel must
read the residuals (2.1 MB as int32) and write 64*2263*16 B ~ 2.3 MB of
fields: ~1.3 us of HBM time at 3.35 TB/s (the NVIDIA H100 SXM data sheet's
rate).  A launch is bound by its slots' instructions and dependent loads,
not bytes; chip_smoke.py measures it.

`frame.assemble_fields` dispatches on the tensors' device: the plain
version for CPU tensors, `assemble_fields_cuda` here for CUDA tensors (it
launches or raises; there is no fallback).  `launches`, `captured` and
`count_replay` count launches as pack_cuda's do, through the encoder's
CUDA graphs too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import format as fmt
from .. import kernels

SOURCE = "flac_tpu_torch/csrc/assemble_fields.cu"
REPLACES = "flac_tpu/models/frame.py:63"        # assemble_frames
_LIB_NAME = "assemble_fields"
HEAD_FIELDS = 11          # header, 7 UTF-8 slots, two tails, CRC-8 slot
MAX_CHANNELS = 8
CLUSTER = 8               # CTAs a frame, at most (CLUSTER in the source)
CTA_TARGET = 512          # CTAs a launch, at most where a frame has > 1
# the kernel's group layouts (LAYOUT in the source)
SAFE, QUAD, WIDE = 0, 1, 2

launches = 0          # kernel launches of K4 in this process
captured = 0          # K4 launches recorded into CUDA graphs (not run)
_lib = None


class FieldLayout(NamedTuple):
    F: int            # fields a frame
    CH: int           # fields a channel
    WS: int           # warm-up slots a channel (64 as pairs when wide)
    G: int            # sample groups a channel (N // m_min)
    per: int          # sample slots a group
    m_min: int        # samples a group: partitions start at its multiples
    max_po: int       # the highest partition order P allows
    group_layout: int  # SAFE, QUAD or WIDE
    segments: tuple   # ((name, first field, fields), ...) in order


@functools.lru_cache(maxsize=None)
def field_layout(C: int, N: int, P: int, quad: bool,
                 wide: bool) -> FieldLayout:
    """The static field layout of a frame of C channels of N samples with
    P partition parameters, for a resolved layout (frame.resolve_layout).
    Raises ValueError for shapes the layout cannot hold."""
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"field_layout: {C} channels, want 1..8")
    max_po = int(P).bit_length() - 1
    m_min = max(N >> max_po, 1)
    if N % m_min:
        raise ValueError(f"field_layout: N={N} is no multiple of the "
                         f"smallest partition ({m_min} samples)")
    if quad and N % 4:
        raise ValueError(f"field_layout: the quad layout needs N % 4 == 0, "
                         f"N={N}")
    if wide:
        group_layout, per = WIDE, 2 * m_min
    elif quad:
        if m_min % 4:
            raise ValueError(f"field_layout: the quad layout needs partitions "
                             f"of a multiple of 4 samples, not {m_min}")
        group_layout, per = QUAD, m_min // 4
    else:
        group_layout, per = SAFE, m_min
    WS = 2 * fmt.MAX_LPC_ORDER if wide else fmt.MAX_LPC_ORDER
    G = N // m_min
    segments = [("header", 0, 1), ("utf8", 1, 7), ("blocksize tail", 8, 1),
                ("rate tail", 9, 1), ("crc8", 10, 1)]
    at = HEAD_FIELDS
    for c in range(C):
        for name, width in (("type", 1), ("wasted", 1), ("warm-up", WS),
                            ("precision/shift", 1),
                            ("coefficients", fmt.MAX_LPC_ORDER),
                            ("method/order", 1), ("prefix 0", 1),
                            ("groups", G * (1 + per))):
            segments.append((f"{name} {c}", at, width))
            at += width
    CH = (at - HEAD_FIELDS) // C
    segments += [("padding", at, 1), ("crc16", at + 1, 1)]
    return FieldLayout(F=at + 2, CH=CH, WS=WS, G=G, per=per, m_min=m_min,
                       max_po=max_po, group_layout=group_layout,
                       segments=tuple(segments))


def cluster_size(B: int) -> int:
    """CTAs a frame in a launch of B frames, as the source chooses them:
    CLUSTER, halved while B times it passes CTA_TARGET (at least 1)."""
    nc = CLUSTER
    while nc > 1 and B * nc > CTA_TARGET:
        nc //= 2
    return nc


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_assemble_fields.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.flac_assemble_fields.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"assemble_fields_cuda: {name} is on {t.device}, "
                         f"not {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"assemble_fields_cuda: {name} is {t.dtype}, want "
                         f"{' or '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != shape:
        raise ValueError(f"assemble_fields_cuda: {name} has shape "
                         f"{tuple(t.shape)}, want {shape}")
    return t.contiguous()


def launch_arguments(choice, signal, assignment, frame_numbers, cfg,
                     blocksize: int, quad: bool, wide: bool):
    """Check K4's inputs (dtypes, shapes, one device) and allocate its
    outputs on their device: (inputs, outputs, ints, layout), the tensors
    in the order of the source's pointer array and the ints of its int
    array.  Raises ValueError on what the kernel does not take."""
    if signal.ndim != 3:
        raise ValueError(f"assemble_fields_cuda: signal has shape "
                         f"{tuple(signal.shape)}, want [B, C, N]")
    dev = signal.device
    B, C, N = signal.shape
    P = choice.params.shape[-1]
    lay = field_layout(C, N, P, quad, wide)
    i32, i64 = (torch.int32,), (torch.int32, torch.int64)
    ins = [_check(name, getattr(choice, name), i32, (B, C), dev)
           for name in ("type_", "order", "wasted", "bps_eff", "precision",
                        "shift", "po")]
    ins += [_check("params", choice.params, i32, (B, C, P), dev),
            _check("use_rice2", choice.use_rice2, (torch.bool,), (B, C),
                   dev),
            _check("residual", choice.residual, i32, (B, C, N), dev),
            _check("warmup", choice.warmup, i64,
                   (B, C, fmt.MAX_LPC_ORDER), dev),
            _check("signal", signal, i64, (B, C, N), dev),
            _check("qcoeffs", choice.qcoeffs, i32,
                   (B, C, fmt.MAX_LPC_ORDER), dev),
            _check("assignment", assignment, i32, (B,), dev),
            _check("frame_numbers", frame_numbers, (torch.int64,), (B,),
                   dev)]
    outs = [torch.empty((B, lay.F), dtype=torch.int32, device=dev),
            torch.empty((B, lay.F), dtype=torch.int64, device=dev),
            torch.empty((B, lay.F), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev)]
    bs_code, bs_tail, bs_tail_bits = fmt.blocksize_code(blocksize)
    sr_code, sr_tail, sr_tail_bits = fmt.sample_rate_code(cfg.sample_rate)
    hdr_base = ((fmt.FRAME_HEADER_SYNC << 18) | (bs_code << 12)
                | (sr_code << 8) | (fmt.bps_code(cfg.bits_per_sample) << 1))
    ints = (B, C, N, P, lay.F, lay.CH, lay.WS, lay.G, lay.per, lay.m_min,
            lay.max_po, hdr_base, bs_tail, bs_tail_bits, sr_tail,
            sr_tail_bits, int(choice.warmup.dtype == torch.int64),
            int(signal.dtype == torch.int64), int(quad and wide))
    return ins, outs, ints, lay


def assemble_fields_cuda(choice, signal, assignment, frame_numbers, cfg,
                         blocksize: int, quad: bool, wide: bool):
    """Launch K4 on one batch: `choice` a SubframeChoice gathered to the
    output channels, `signal` [B, C, N] int32 or int64, `assignment` [B]
    int32, `frame_numbers` [B] int64 (< 2^36), all on one CUDA device;
    (quad, wide) the resolved layout.  Returns (nzeros [B, F] int32,
    payload [B, F] int64, pbits [B, F] int32, bits [B] int32, ok [B] bool,
    hdr_bytes [B] int32), as the plain version."""
    global launches, captured
    if signal.device.type != "cuda":
        raise ValueError("assemble_fields_cuda: signal is not on a GPU")
    ins, outs, ints, lay = launch_arguments(
        choice, signal, assignment, frame_numbers, cfg, blocksize, quad,
        wide)
    if signal.shape[0] == 0:
        return tuple(outs)
    ptrs = (ctypes.c_void_p * len(ins + outs))(
        *[t.data_ptr() for t in ins + outs])
    int_arr = (ctypes.c_longlong * len(ints))(*ints)
    with torch.cuda.device(signal.device):
        lib = _library()
        kernels.check(lib.flac_assemble_fields(
            ptrs, len(ptrs), int_arr, len(int_arr), lay.group_layout,
            torch.cuda.current_stream().cuda_stream),
            "flac_assemble_fields launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return tuple(outs)


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K4 launches was replayed: they ran."""
    global launches
    launches += n
