"""Encoder configuration — presets and derived static parameters.

Mirrors the reference's compression-level table and init-time resolution
(src/libFLAC/stream_encoder.c:117-140 presets, :707-840 defaults/clamps) as
a frozen dataclass usable as a static jit argument.
"""

from __future__ import annotations

import dataclasses

from . import format as fmt

# preset table (stream_encoder.c:117-140):
# (do_mid_side, loose_mid_side, max_lpc_order, qlp_coeff_precision,
#  do_qlp_coeff_prec_search, do_escape_coding, do_exhaustive_model_search,
#  min_partition_order, max_partition_order, rice_parameter_search_dist,
#  apodization)
_PRESETS = (
    (False, False, 0, 0, False, False, False, 0, 3, 0, "tukey(5e-1)"),
    (True, True, 0, 0, False, False, False, 0, 3, 0, "tukey(5e-1)"),
    (True, False, 0, 0, False, False, False, 0, 3, 0, "tukey(5e-1)"),
    (False, False, 6, 0, False, False, False, 0, 4, 0, "tukey(5e-1)"),
    (True, True, 8, 0, False, False, False, 0, 4, 0, "tukey(5e-1)"),
    (True, False, 8, 0, False, False, False, 0, 5, 0, "tukey(5e-1)"),
    (True, False, 8, 0, False, False, False, 0, 6, 0, "subdivide_tukey(2)"),
    (True, False, 12, 0, False, False, False, 0, 6, 0, "subdivide_tukey(2)"),
    (True, False, 12, 0, False, False, False, 0, 6, 0, "subdivide_tukey(3)"),
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static encoder parameters (hashable; used as a jit static arg)."""
    sample_rate: int = 44100
    channels: int = 2
    bits_per_sample: int = 16
    blocksize: int = 4096
    do_mid_side: bool = True
    loose_mid_side: bool = False
    max_lpc_order: int = 8
    qlp_coeff_precision: int = 0      # 0 = auto from blocksize/bps
    do_qlp_coeff_prec_search: bool = False
    do_escape_coding: bool = False
    do_exhaustive_model_search: bool = False
    min_residual_partition_order: int = 0
    max_residual_partition_order: int = 5
    rice_parameter_search_dist: int = 0
    apodizations: tuple = ("tukey(5e-1)",)
    streamable_subset: bool = True
    limit_min_bitrate: bool = False

    @classmethod
    def from_preset(cls, level: int, **overrides) -> "EncoderConfig":
        (ms, loose, lpc, qlp, qlps, esc, exh, minpo, maxpo, dist,
         apod) = _PRESETS[level]
        base = dict(do_mid_side=ms, loose_mid_side=loose, max_lpc_order=lpc,
                    qlp_coeff_precision=qlp, do_qlp_coeff_prec_search=qlps,
                    do_escape_coding=esc, do_exhaustive_model_search=exh,
                    min_residual_partition_order=minpo,
                    max_residual_partition_order=maxpo,
                    rice_parameter_search_dist=dist,
                    apodizations=(apod,))
        base.update(overrides)
        return cls(**base)

    def resolve(self) -> "EncoderConfig":
        """Apply init-time defaulting (stream_encoder.c:707-840)."""
        c = self
        blocksize = c.blocksize
        if blocksize == 0:
            blocksize = 1152 if c.max_lpc_order == 0 else 4096
        qlp = c.qlp_coeff_precision
        if qlp == 0:
            bps = c.bits_per_sample
            if bps < 16:
                qlp = max(fmt.MIN_QLP_COEFF_PRECISION, 2 + bps // 2)
            elif bps == 16:
                for limit, p in ((192, 7), (384, 8), (576, 9), (1152, 10),
                                 (2304, 11), (4608, 12)):
                    if blocksize <= limit:
                        qlp = p
                        break
                else:
                    qlp = 13
            else:
                if blocksize <= 384:
                    qlp = fmt.MAX_QLP_COEFF_PRECISION - 2
                elif blocksize <= 1152:
                    qlp = fmt.MAX_QLP_COEFF_PRECISION - 1
                else:
                    qlp = fmt.MAX_QLP_COEFF_PRECISION
        maxpo = min(c.max_residual_partition_order, 15)
        minpo = min(c.min_residual_partition_order, maxpo)
        # at bps=32 the side channel is 33-bit (stream_encoder.c:152
        # integer_signal_33bit_side): the candidate tensor switches to
        # exact f64 and the packer splits >32-bit payloads — see
        # models/stereo.py build_channel_candidates
        do_ms = c.do_mid_side and c.channels == 2
        return dataclasses.replace(
            c, blocksize=blocksize, qlp_coeff_precision=qlp,
            max_residual_partition_order=maxpo,
            min_residual_partition_order=minpo, do_mid_side=do_ms,
            loose_mid_side=c.loose_mid_side and do_ms)

    # ---- derived static properties ----

    @property
    def max_partition_order_static(self) -> int:
        """Blocksize-divisibility cap on the partition order."""
        return fmt.max_rice_partition_order_limited(
            self.max_residual_partition_order, self.blocksize, 0)

    @property
    def rice_param_limit(self) -> int:
        """Max Rice parameter: RICE2 space only for bps > 16
        (stream_encoder.c:4076)."""
        return (fmt.ENTROPY_CODING_METHOD_PARTITIONED_RICE2_ESCAPE_PARAMETER
                if self.bits_per_sample > 16 else
                fmt.ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER)

    @property
    def max_subframe_bps(self) -> int:
        """Largest subframe bps: stream bps + 1 for the side channel."""
        extra = 1 if (self.channels == 2 and self.do_mid_side) else 0
        return self.bits_per_sample + extra
