"""Frame assembly: subframe choices -> field lists -> packed FLAC frames.

Port of flac_tpu/models/frame.py (the reference's per-frame sequential
framing, stream_encoder_framing.c + bitwriter.c, recast) in three steps:

1. fields: every frame in the batch becomes a fixed-shape list of
   (nzeros, payload, pbits) fields (assemble_fields: kernel K4 on a GPU,
   ops/assemble_cuda.py; its plain version assemble_fields_plain);
2. pack: ops/bitpack.py (safe layout) or kernel K1 (quad layout,
   ops/pack_cuda.py) deposits them into word buffers in parallel;
3. seal: CRC-8 and CRC-16 are computed on the device and deposited into
   their (zero) slots (seal_frames: kernel K5 on a GPU, ops/seal_cuda.py;
   its plain version seal_frames_plain).

Unsigned payloads are carried in int64 (uint32 values, and uint64 bit
patterns of the quad layout's fused <=63-bit payloads).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import format as fmt
from ..config import EncoderConfig
from ..device import constant
from ..ops import assemble_cuda, bitpack, pack_cuda, seal_cuda
from ..ops import rice as rice_ops
from .subframe import SubframeChoice

_UTF8_SLOTS = 7
U32 = bitpack.U32


class PackedFrames(NamedTuple):
    words: torch.Tensor      # [B, W] int64 holding uint32 big-endian words
    byte_len: torch.Tensor   # [B] int32
    bits: torch.Tensor       # [B] int32 diagnostic: pre-padding frame bits
    ok: torch.Tensor         # [B] bool: packed exactly (quad layout fit);
    #                          False -> re-encode the frame via the safe
    #                          layout (rare: pathological k/q)


class FrameFields(NamedTuple):
    nzeros: torch.Tensor     # [B, F] int32 leading zero bits of each field
    payload: torch.Tensor    # [B, F] int64 payload bits (LSB-aligned)
    pbits: torch.Tensor      # [B, F] int32 payload bit count
    bits: torch.Tensor       # [B] int32 frame bits before the padding
    ok: torch.Tensor         # [B] bool quad layout fit (True otherwise)
    hdr_bytes: torch.Tensor  # [B] int32 header bytes under the CRC-8


def _utf8_fields(n):
    """FLAC UTF-8 number coding -> 7 byte fields (bitwriter.c:832-930).

    n: [B] int64 (< 2^36).  Returns (payload [B,7] int64, pbits [B,7]
    int32, length [B] int64).
    """
    n = n.to(torch.int64)
    thresholds = constant("utf8 thresholds", n.device, lambda d: torch.tensor(
        [0x80, 0x800, 0x10000, 0x200000, 0x4000000, 0x80000000,
         0x1000000000], dtype=torch.int64, device=d))
    L = 1 + (n[:, None] >= thresholds[None, :]).sum(dim=1)  # [B] 1..7
    lead_mask = constant("utf8 lead masks", n.device, lambda d: torch.tensor(
        [0, 0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE], dtype=torch.int64,
        device=d))
    payloads, pbits = [], []
    for j in range(_UTF8_SLOTS):
        sh = torch.clamp(6 * (L - 1 - j), 0, 63)
        chunk = (n >> sh) & 0x3F
        lead_bits = torch.clamp(7 - L, 0, 7)  # payload bits in lead byte
        lead_val = lead_mask[L] | ((n >> sh) & ((1 << lead_bits) - 1))
        if j == 0:
            b = torch.where(L == 1, n, lead_val)
        else:
            b = 0x80 | chunk
        valid = j < L
        payloads.append(torch.where(valid, b, 0) & U32)
        pbits.append(torch.where(valid, 8, 0).to(torch.int32))
    return torch.stack(payloads, 1), torch.stack(pbits, 1), L


def _low_mask(nbits):
    """(1 << nbits) - 1 for nbits in [0, 32], as int64 (uint32 values)."""
    return (torch.ones_like(nbits, dtype=torch.int64)
            << nbits.to(torch.int64)) - 1


def resolve_layout(cfg: EncoderConfig, N: int, P: int,
                   layout: str) -> tuple[bool, bool]:
    """(quad, wide) of a batch of N-sample frames with P partition
    parameters: quad for layout "quad", or for "auto" where the fused-quad
    layout is eligible; wide in the 33-bit side configuration (bps 32 with
    mid-side), where a warm-up or verbatim sample can need 33 bits, beyond
    a safe-layout field's 32: each goes out as a (high, low-16) field
    pair."""
    if layout not in ("auto", "quad", "safe"):
        raise ValueError(f"unknown layout {layout!r}")
    m_min = max(N >> (int(P).bit_length() - 1), 1)
    if layout == "auto":
        layout = "quad" if (cfg.max_subframe_bps <= 32
                            and cfg.bits_per_sample <= 26
                            and N % 4 == 0 and m_min % 4 == 0) \
            else "safe"
    return layout == "quad", cfg.max_subframe_bps > 32


def assemble_fields_plain(choice: SubframeChoice, signal, assignment,
                          frame_numbers, cfg: EncoderConfig, blocksize: int,
                          layout: str = "auto") -> FrameFields:
    """The field lists of one batch of frames, op by op: the plain version
    of kernel K4 (ops/assemble_cuda.py).  Arguments as assemble_frames'."""
    B, C, N = signal.shape
    dev = signal.device
    P = choice.params.shape[-1]
    max_po = int(P).bit_length() - 1
    m_min = max(N >> max_po, 1)      # partitions start at multiples of this
    quad, wide = resolve_layout(cfg, N, P, layout)

    nz_list, pay_list, pb_list = [], [], []
    fit_list = []

    def add(nzeros, payload, pbits):
        nz_list.append(nzeros.to(torch.int32))
        pay_list.append(payload.to(torch.int64))
        pb_list.append(pbits.to(torch.int32))

    def full(value, width=1, dtype=torch.int32):
        return torch.full((B, width), value, dtype=dtype, device=dev)

    zeros1 = full(0)

    # ---- frame header: first 4 bytes ----
    bs_code, bs_tail, bs_tail_bits = fmt.blocksize_code(blocksize)
    sr_code, sr_tail, sr_tail_bits = fmt.sample_rate_code(cfg.sample_rate)
    bps_code = fmt.bps_code(cfg.bits_per_sample)
    if C == 2:
        ch_code = torch.where(assignment == 0, 1, 7 + assignment)
    else:
        ch_code = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
    hdr32 = ((fmt.FRAME_HEADER_SYNC << 18)  # sync(14) res(1) blocking(1)=0
             | (bs_code << 12) | (sr_code << 8)
             | (ch_code.to(torch.int64) << 4) | (bps_code << 1))
    add(zeros1, (hdr32 & U32)[:, None], full(32))

    # ---- UTF-8 frame number ----
    u8_pay, u8_pb, u8_len = _utf8_fields(frame_numbers)
    add(torch.zeros_like(u8_pb), u8_pay, u8_pb)

    # ---- blocksize / sample-rate tails ----
    add(zeros1, full(bs_tail, dtype=torch.int64), full(bs_tail_bits))
    add(zeros1, full(sr_tail, dtype=torch.int64), full(sr_tail_bits))

    # ---- CRC-8 slot (value deposited after packing) ----
    add(zeros1, full(0, dtype=torch.int64), full(8))
    hdr_bytes = (4 + u8_len.to(torch.int32) + (bs_tail_bits // 8)
                 + (sr_tail_bits // 8))   # bytes covered by CRC-8

    # ---- per-channel subframes ----
    n_idx = torch.arange(N, dtype=torch.int32, device=dev)
    j_idx = torch.arange(fmt.MAX_LPC_ORDER, dtype=torch.int32, device=dev)
    for c in range(C):
        t = choice.type_[:, c]
        order = choice.order[:, c]
        wasted = choice.wasted[:, c]
        bps_eff = choice.bps_eff[:, c]
        prec = choice.precision[:, c]
        shift = choice.shift[:, c]
        po = choice.po[:, c]
        params = choice.params[:, c]      # [B, P]
        rice2 = choice.use_rice2[:, c]
        residual = choice.residual[:, c]  # [B, N] int32
        warm = choice.warmup[:, c]        # [B, 32]
        sig = signal[:, c]

        is_c = t == fmt.SUBFRAME_TYPE_CONSTANT
        is_v = t == fmt.SUBFRAME_TYPE_VERBATIM
        is_f = t == fmt.SUBFRAME_TYPE_FIXED
        is_l = t == fmt.SUBFRAME_TYPE_LPC
        has_res = is_f | is_l

        # subframe header byte: pad(1)+type(6)+wasted_flag(1)
        type_byte = torch.where(
            is_c, 0x00, torch.where(
                is_v, 0x02, torch.where(
                    is_f, 0x10 | (order << 1), 0x40 | ((order - 1) << 1))))
        wflag = (wasted > 0).to(torch.int32)
        add(zeros1, ((type_byte | wflag).to(torch.int64) & U32)[:, None],
            full(8))
        # wasted unary: (w-1) zeros + stop bit
        add(torch.clamp(wasted - 1, min=0)[:, None], wflag[:, None],
            wflag[:, None])

        # warmup samples (bps_eff bits each) / constant value — warmup
        # precedes the LPC precision/shift/coefficient fields in the spec
        wmask = (torch.ones_like(bps_eff, dtype=torch.int64)
                 << bps_eff.to(torch.int64)) - 1
        wm64 = warm.to(torch.int64) & wmask[:, None]
        w_active = (has_res[:, None] & (j_idx < order[:, None])) \
            | (is_c[:, None] & (j_idx == 0))
        if wide:
            hi_bits = torch.clamp(bps_eff - 16, 0, 17)[:, None]
            lo_bits = torch.clamp(bps_eff, max=16)[:, None]
            pair_pay = torch.stack([wm64 >> 16, wm64 & 0xFFFF], dim=-1)
            pair_pb = torch.stack([torch.where(w_active, hi_bits, 0),
                                   torch.where(w_active, lo_bits, 0)],
                                  dim=-1)
            M2 = 2 * fmt.MAX_LPC_ORDER
            add(torch.zeros((B, M2), dtype=torch.int32, device=dev),
                pair_pay.reshape(B, M2), pair_pb.reshape(B, M2))
        else:
            wpay = wm64 & U32
            wpb = torch.where(w_active, bps_eff[:, None], 0)
            add(torch.zeros_like(wpb), wpay, wpb)

        # LPC precision-1 (4 bits) + shift (5 bits)
        add(zeros1,
            ((((prec - 1) << 5) | shift).to(torch.int64) & U32)[:, None],
            torch.where(is_l, 9, 0)[:, None])

        # LPC coefficients (prec bits each, signed two's complement)
        cmask = (torch.ones_like(prec, dtype=torch.int64)
                 << prec.to(torch.int64)) - 1
        qpay = (choice.qcoeffs[:, c].to(torch.int64) & cmask[:, None]) & U32
        cpb = torch.where(is_l[:, None] & (j_idx < order[:, None]),
                          prec[:, None], 0)
        add(torch.zeros_like(cpb), qpay, cpb)

        # residual method (2) + partition order (4)
        add(zeros1,
            ((rice2.to(torch.int64) << 4) | po.to(torch.int64))[:, None],
            torch.where(has_res, 6, 0)[:, None])

        # samples: Rice codes (fixed/lpc) or raw (verbatim).
        u = rice_ops.zigzag(residual)                     # [B, N] int64
        # per-sample parameter: params repeated over each partition
        k_n = params[:, :1].expand(B, N)
        for p_o in range(max_po + 1):
            parts_o = 1 << p_o
            if N % parts_o:
                continue
            expand = torch.repeat_interleave(params[:, :parts_o],
                                             N // parts_o, dim=1,
                                             output_size=N)
            k_n = torch.where(po[:, None] == p_o, expand, k_n)
        # escaped partitions (k sentinel >= ESCAPE_K_BASE): raw n-bit
        # signed residuals instead of rice codes (decoder at
        # stream_decoder.c:3338-3352)
        esc_n = k_n >= rice_ops.ESCAPE_K_BASE
        rawb_n = torch.where(esc_n, k_n - rice_ops.ESCAPE_K_BASE, 0)
        k_s = torch.where(esc_n, 0, k_n).to(torch.int64)
        q = (u >> k_s).to(torch.int32)
        rice_pay = ((1 << k_s) | (u & ((1 << k_s) - 1))) & U32
        raw_pay = (residual.to(torch.int64) & U32) & _low_mask(
            torch.clamp(rawb_n, 0, 31))
        in_res = n_idx[None, :] >= order[:, None]
        active = has_res[:, None] & in_res
        s_nz = torch.where(active & ~esc_n, q, 0)
        if wide:
            # verbatim samples as (high, low-16) slot pairs: the high
            # half goes in the sample's own slot, the low one after it
            sig64 = sig.to(torch.int64) & wmask[:, None]
            verb_pay, verb_pb = sig64 >> 16, hi_bits
            sl_pay = torch.where(is_v[:, None], sig64 & 0xFFFF, 0)
            sl_pb = torch.where(is_v[:, None], lo_bits, 0).expand(B, N)
        else:
            smask = torch.where(bps_eff >= 32, U32, _low_mask(
                torch.clamp(bps_eff, 0, 31)))[:, None]
            verb_pay = (sig.to(torch.int64) & U32) & smask
            verb_pb = bps_eff[:, None]
        s_pay = torch.where(active, torch.where(esc_n, raw_pay, rice_pay),
                            torch.where(is_v[:, None], verb_pay, 0))
        s_pb = torch.where(active, torch.where(esc_n, rawb_n, k_n + 1),
                           torch.where(is_v[:, None], verb_pb, 0))
        if quad:
            # fused-quad layout: each field carries 4 samples' codes —
            # sample 4g's unary zeros stay free in nzeros, the rest of
            # the run (stop+LSBs, inner unary zeros) concatenates into
            # one <=63-bit payload.  Frames that don't fit are flagged.
            pre4 = s_nz.reshape(B, N // 4, 4)
            pay4 = s_pay.reshape(B, N // 4, 4)
            pb4 = s_pb.reshape(B, N // 4, 4)
            pay64 = pay4[:, :, 0]
            pb64 = pb4[:, :, 0]
            for i4 in range(1, 4):
                step = pre4[:, :, i4] + pb4[:, :, i4]
                pay64 = (pay64 << torch.clamp(step, 0, 63).to(torch.int64)) \
                    | pay4[:, :, i4]
                pb64 = pb64 + step
            fit_list.append((pb64 <= 63).all(dim=1))
            s_nz_q = pre4[:, :, 0]

        # partition parameter prefixes, placed at the only positions
        # partitions can start: partition 0's prefix precedes the first
        # coded sample (slots < order are empty, so a single field before
        # the sample array lands correctly), and starts p*m (p >= 1) are
        # always multiples of m_min = N >> max_po — one slot per m_min
        # samples.
        plen = torch.where(rice2, 5, 4).to(torch.int64)
        esc_mark = (((1 << plen) - 1) << 5) & U32

        def prefix_fields(kvals):
            """Parameter-prefix payload/width from sentinel-encoded k:
            normal -> (k, plen); escaped -> (1..1 marker ++ 5-bit raw
            width, plen+5)."""
            e = kvals >= rice_ops.ESCAPE_K_BASE
            raw = (kvals - rice_ops.ESCAPE_K_BASE).to(torch.int64) & U32
            pay = torch.where(e, esc_mark[:, None] | raw,
                              kvals.to(torch.int64) & U32)
            pb = torch.where(e, plen[:, None] + 5, plen[:, None])
            return pay, pb

        p0_pay, p0_pb = prefix_fields(params[:, :1])
        add(zeros1, p0_pay, torch.where(has_res[:, None], p0_pb, 0))
        G = N // m_min
        g_idx = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
        # group g starts a partition iff g is a multiple of m/m_min
        # = 2^(max_po - po) (a power of two even when N is not)
        ratio = ((1 << max_po) >> po)[:, None]               # [B, 1]
        b_active = has_res[:, None] & (g_idx > 0) & \
            ((g_idx & (ratio - 1)) == 0)
        b_pay, b_pb_all = prefix_fields(k_n[:, ::m_min])          # [B, G]
        b_pb = torch.where(b_active, b_pb_all, 0)
        if wide:
            per = 2 * m_min
            s_nz_g = torch.stack([s_nz, torch.zeros_like(s_nz)],
                                 dim=-1).reshape(B, G, per)
            s_pay_g = torch.stack([s_pay, sl_pay], dim=-1).reshape(B, G, per)
            s_pb_g = torch.stack([s_pb, sl_pb.to(s_pb.dtype)],
                                 dim=-1).reshape(B, G, per)
        elif quad:
            per = m_min // 4
            s_nz_g = s_nz_q.reshape(B, G, per)
            s_pay_g = pay64.reshape(B, G, per)
            s_pb_g = pb64.reshape(B, G, per)
        else:
            per = m_min
            s_nz_g = s_nz.reshape(B, G, per)
            s_pay_g = s_pay.reshape(B, G, per)
            s_pb_g = s_pb.reshape(B, G, per)
        grp_nz = torch.cat([torch.zeros((B, G, 1), dtype=torch.int32,
                                        device=dev), s_nz_g], dim=2)
        grp_pay = torch.cat([b_pay[:, :, None], s_pay_g], dim=2)
        grp_pb = torch.cat([b_pb[:, :, None].to(s_pb_g.dtype), s_pb_g],
                           dim=2)
        add(grp_nz.reshape(B, G * (1 + per)),
            grp_pay.reshape(B, G * (1 + per)),
            grp_pb.reshape(B, G * (1 + per)))

    # ---- byte-align padding + CRC-16 slot ----
    bits_so_far = sum((nz + pb).sum(dim=1, dtype=torch.int32)
                      for nz, pb in zip(nz_list, pb_list))
    pad = torch.remainder(-bits_so_far, 8).to(torch.int32)
    add(pad[:, None], full(0, dtype=torch.int64), zeros1)
    add(zeros1, full(0, dtype=torch.int64), full(16))

    ok = torch.ones((B,), dtype=torch.bool, device=dev)
    for f in fit_list:
        ok = ok & f
    return FrameFields(nzeros=torch.cat(nz_list, dim=1),
                       payload=torch.cat(pay_list, dim=1),
                       pbits=torch.cat(pb_list, dim=1),
                       bits=bits_so_far, ok=ok, hdr_bytes=hdr_bytes)


def assemble_fields(choice: SubframeChoice, signal, assignment,
                    frame_numbers, cfg: EncoderConfig, blocksize: int,
                    layout: str = "auto") -> FrameFields:
    """K4's wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (it launches or raises)."""
    if signal.device.type == "cpu":
        return assemble_fields_plain(choice, signal, assignment,
                                     frame_numbers, cfg, blocksize, layout)
    if signal.device.type == "cuda":
        quad, wide = resolve_layout(cfg, signal.shape[2],
                                    choice.params.shape[-1], layout)
        return FrameFields(*assemble_cuda.assemble_fields_cuda(
            choice, signal, assignment, frame_numbers, cfg, blocksize,
            quad, wide))
    raise ValueError(f"assemble_fields: unsupported device {signal.device}")


def seal_frames_plain(words, byte_len, hdr_bytes):
    """CRC-8 over each frame's header and CRC-16 over its first
    byte_len - 2 bytes, deposited into their zero slots, op by op: the
    plain version of kernel K5 (ops/seal_cuda.py).  words: [B, W] int64
    holding uint32 (bytes past byte_len - 2 zero); byte_len, hdr_bytes:
    [B] int32.  Returns new words."""
    # CRC-8 over the header prefix, deposited as the last header byte
    hdr_bytes_view = bitpack.words_to_bytes(words[:, :4])
    crc8 = bitpack.crc8_prefix(hdr_bytes_view, hdr_bytes, 16)
    words = bitpack.deposit_byte(words, hdr_bytes, crc8)

    # CRC-16 over everything before the 2-byte CRC field
    crc16 = bitpack.crc16_words(words, byte_len - 2)
    words = bitpack.deposit_byte(words, byte_len - 2, crc16 >> 8)
    return bitpack.deposit_byte(words, byte_len - 1, crc16 & 0xFF)


def seal_frames(words, byte_len, hdr_bytes):
    """K5's wrapper: the plain version for CPU tensors (new words), the
    kernel for CUDA tensors (it seals `words` in place and returns them)."""
    if words.device.type == "cpu":
        return seal_frames_plain(words, byte_len, hdr_bytes)
    if words.device.type == "cuda":
        return seal_cuda.seal_frames_cuda(words, byte_len, hdr_bytes)
    raise ValueError(f"seal_frames: unsupported device {words.device}")


def max_words(cfg: EncoderConfig, C: int, N: int, P: int) -> int:
    """The word rows' width: the worst case (verbatim subframes and full
    headers), rounded up to a power of two."""
    worst_bits = 64 * 8 + C * (N * (cfg.max_subframe_bps) + 16 * 8
                               + 32 * (fmt.MAX_QLP_COEFF_PRECISION + 33)
                               + P * 10)
    return 1 << int(np.ceil(np.log2(worst_bits / 32 + 2)))


def assemble_frames(choice: SubframeChoice, signal, assignment,
                    frame_numbers, cfg: EncoderConfig,
                    blocksize: int, layout: str = "auto",
                    packer: str = "kernel") -> PackedFrames:
    """Build and pack one batch of frames: K4 builds the field lists, K1
    (quad layout) or the safe scatter deposits them, K5 seals the CRCs.

    choice:        SubframeChoice gathered to output channels [B, C, ...]
    signal:        [B, C, N] wasted-shifted signals (verbatim payloads):
                   int32, or int64 in the 33-bit side configuration
    assignment:    [B] int32 channel assignment (0..3), 0 for non-stereo
    frame_numbers: [B] int64 (< 2^36)
    blocksize:     N for this batch
    layout:        "safe"  — one field per residual sample (always exact);
                   "quad"  — four Rice codes fused per 64-bit field; frames
                             whose codes don't fit 63 payload bits come
                             back with ok=False and the caller re-encodes
                             them via "safe";
                   "auto"  — quad when eligible.
    packer:        quad-layout deposit: "kernel" — K1's wrapper (the CUDA
                   kernel on a GPU, its plain version on the CPU); "plain"
                   — the plain version on any device (for A/B runs).
    K4 and K5 go through their wrappers on every device.
    """
    if packer not in ("kernel", "plain"):
        raise ValueError(f"unknown packer {packer!r}")
    B, C, N = signal.shape
    P = choice.params.shape[-1]
    quad, _ = resolve_layout(cfg, N, P, layout)
    with record_function("flac.fields"):
        f = assemble_fields(choice, signal, assignment, frame_numbers, cfg,
                            blocksize, layout)
    W = max_words(cfg, C, N, P)
    with record_function("flac.pack"):
        if not quad:
            words, total_bits = bitpack.pack_fields(f.nzeros, f.payload,
                                                    f.pbits, W)
        elif packer == "kernel":
            words, total_bits = pack_cuda.pack_fields64(f.nzeros, f.payload,
                                                        f.pbits, W)
        else:
            words, total_bits = bitpack.pack_fields64(f.nzeros, f.payload,
                                                      f.pbits, W)
    byte_len = total_bits // 8
    with record_function("flac.seal"):
        words = seal_frames(words, byte_len, f.hdr_bytes)
    return PackedFrames(words=words, byte_len=byte_len, bits=f.bits,
                        ok=f.ok)
