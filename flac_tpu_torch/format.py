"""FLAC format constants, code tables, and validation predicates.

TPU-native rebuild of the reference format layer
(libFLAC: include/FLAC/format.h, src/libFLAC/format.c).
Everything here is pure Python — constants consumed statically at JAX trace
time and host-side validation helpers.
"""

from __future__ import annotations

# --- Stream-level constants (format.h:96-148) ---
MIN_BLOCK_SIZE = 16
MAX_BLOCK_SIZE = 65535
SUBSET_MAX_BLOCK_SIZE_48000HZ = 4608
MAX_CHANNELS = 8
MIN_BITS_PER_SAMPLE = 4
MAX_BITS_PER_SAMPLE = 32
MAX_SAMPLE_RATE = 1048575
MAX_LPC_ORDER = 32
SUBSET_MAX_LPC_ORDER_48000HZ = 12
MIN_QLP_COEFF_PRECISION = 5
MAX_QLP_COEFF_PRECISION = 15
MAX_FIXED_ORDER = 4
MAX_RICE_PARTITION_ORDER = 15
SUBSET_MAX_RICE_PARTITION_ORDER = 8

STREAM_SYNC_STRING = b"fLaC"

# --- Metadata block types (format.h:496-524) ---
METADATA_TYPE_STREAMINFO = 0
METADATA_TYPE_PADDING = 1
METADATA_TYPE_APPLICATION = 2
METADATA_TYPE_SEEKTABLE = 3
METADATA_TYPE_VORBIS_COMMENT = 4
METADATA_TYPE_CUESHEET = 5
METADATA_TYPE_PICTURE = 6

STREAM_METADATA_STREAMINFO_LENGTH = 34
STREAM_METADATA_HEADER_LENGTH = 4
STREAM_METADATA_SEEKPOINT_LENGTH = 18
SEEKPOINT_PLACEHOLDER = 0xFFFFFFFFFFFFFFFF

# --- Frame header field widths (format.h:416-475) ---
FRAME_HEADER_SYNC = 0b11111111111110
FRAME_HEADER_SYNC_LEN = 14
FRAME_HEADER_RESERVED_LEN = 1
FRAME_HEADER_BLOCKING_STRATEGY_LEN = 1
FRAME_HEADER_BLOCK_SIZE_LEN = 4
FRAME_HEADER_SAMPLE_RATE_LEN = 4
FRAME_HEADER_CHANNEL_ASSIGNMENT_LEN = 4
FRAME_HEADER_BITS_PER_SAMPLE_LEN = 3
FRAME_HEADER_ZERO_PAD_LEN = 1
FRAME_HEADER_CRC_LEN = 8
FRAME_FOOTER_CRC_LEN = 16

# --- Subframe header (format.h:264-380) ---
SUBFRAME_ZERO_PAD_LEN = 1
SUBFRAME_TYPE_LEN = 6
SUBFRAME_WASTED_BITS_FLAG_LEN = 1
SUBFRAME_TYPE_CONSTANT_BYTE_ALIGNED_MASK = 0x00
SUBFRAME_TYPE_VERBATIM_BYTE_ALIGNED_MASK = 0x02
SUBFRAME_TYPE_FIXED_BYTE_ALIGNED_MASK = 0x10
SUBFRAME_TYPE_LPC_BYTE_ALIGNED_MASK = 0x40

SUBFRAME_LPC_QLP_COEFF_PRECISION_LEN = 4
SUBFRAME_LPC_QLP_SHIFT_LEN = 5

# Subframe model type enum (matches FLAC__SubframeType order, format.h:264-269)
SUBFRAME_TYPE_CONSTANT = 0
SUBFRAME_TYPE_VERBATIM = 1
SUBFRAME_TYPE_FIXED = 2
SUBFRAME_TYPE_LPC = 3

# --- Entropy coding (format.h:191-248) ---
ENTROPY_CODING_METHOD_PARTITIONED_RICE = 0
ENTROPY_CODING_METHOD_PARTITIONED_RICE2 = 1
ENTROPY_CODING_METHOD_TYPE_LEN = 2
ENTROPY_CODING_METHOD_PARTITIONED_RICE_ORDER_LEN = 4
ENTROPY_CODING_METHOD_PARTITIONED_RICE_PARAMETER_LEN = 4
ENTROPY_CODING_METHOD_PARTITIONED_RICE2_PARAMETER_LEN = 5
ENTROPY_CODING_METHOD_PARTITIONED_RICE_RAW_LEN = 5
ENTROPY_CODING_METHOD_PARTITIONED_RICE_ESCAPE_PARAMETER = 15
ENTROPY_CODING_METHOD_PARTITIONED_RICE2_ESCAPE_PARAMETER = 31

# --- Channel assignments (format.h:388-393) ---
CHANNEL_ASSIGNMENT_INDEPENDENT = 0
CHANNEL_ASSIGNMENT_LEFT_SIDE = 1
CHANNEL_ASSIGNMENT_RIGHT_SIDE = 2
CHANNEL_ASSIGNMENT_MID_SIDE = 3

# Maximum extra bits-per-sample the encoder assumes for residual magnitudes
# (private/format.h FLAC__MAX_EXTRA_RESIDUAL_BPS)
MAX_EXTRA_RESIDUAL_BPS = 4

# --- Frame header code tables ---
# Block size 4-bit codes (stream_encoder_framing.c:245-290):
#   0000 reserved; 0001 = 192; 0010-0101 = 576 * 2^(n-2);
#   0110 = 8-bit (blocksize-1) follows; 0111 = 16-bit (blocksize-1) follows;
#   1000-1111 = 256 * 2^(n-8).
BLOCKSIZE_CODES = {
    192: 1,
    576: 2, 1152: 3, 2304: 4, 4608: 5,
    256: 8, 512: 9, 1024: 10, 2048: 11,
    4096: 12, 8192: 13, 16384: 14, 32768: 15,
}

# Sample rate 4-bit codes (stream_encoder_framing.c:292-335):
SAMPLE_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}
SAMPLE_RATE_CODE_GET_8BIT_KHZ = 12    # 8-bit sample rate in kHz follows
SAMPLE_RATE_CODE_GET_16BIT_HZ = 13    # 16-bit sample rate in Hz follows
SAMPLE_RATE_CODE_GET_16BIT_10HZ = 14  # 16-bit sample rate in daHz follows

# Bits-per-sample 3-bit codes (frame header):
BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
# code 0 = get from STREAMINFO; code 3 reserved.


def blocksize_code(blocksize: int) -> tuple[int, int, int]:
    """Return (4-bit code, tail_value, tail_bits) for a frame blocksize.

    Mirrors the encoder's choice in frame_add_header
    (reference src/libFLAC/stream_encoder_framing.c:253-273): exact table
    match preferred, else 8/16-bit blocksize-1 from end.
    """
    if blocksize in BLOCKSIZE_CODES:
        return BLOCKSIZE_CODES[blocksize], 0, 0
    if blocksize <= 256:
        return 6, blocksize - 1, 8
    return 7, blocksize - 1, 16


def sample_rate_code(sample_rate: int) -> tuple[int, int, int]:
    """Return (4-bit code, tail_value, tail_bits) for the frame sample rate.

    Mirrors frame_add_header (stream_encoder_framing.c:292-335).
    """
    if sample_rate in SAMPLE_RATE_CODES:
        return SAMPLE_RATE_CODES[sample_rate], 0, 0
    if sample_rate <= 255000 and sample_rate % 1000 == 0:
        return SAMPLE_RATE_CODE_GET_8BIT_KHZ, sample_rate // 1000, 8
    if sample_rate <= 655350 and sample_rate % 10 == 0:
        return SAMPLE_RATE_CODE_GET_16BIT_10HZ, sample_rate // 10, 16
    if sample_rate <= 0xFFFF:
        return SAMPLE_RATE_CODE_GET_16BIT_HZ, sample_rate, 16
    # Unrepresentable in a frame header: rely on STREAMINFO (code 0).
    return 0, 0, 0


def bps_code(bits_per_sample: int) -> int:
    """3-bit frame-header bits-per-sample code (0 = get from STREAMINFO)."""
    return BPS_CODES.get(bits_per_sample, 0)


def sample_rate_is_valid(sample_rate: int) -> bool:
    """format.c FLAC__format_sample_rate_is_valid."""
    return 0 < sample_rate <= MAX_SAMPLE_RATE


def sample_rate_is_subset(sample_rate: int) -> bool:
    """format.c:210-216: subset needs the rate representable in a frame header."""
    if not sample_rate_is_valid(sample_rate):
        return False
    # representable via table or the three get-from-end forms
    code, _, _ = sample_rate_code(sample_rate)
    return code != 0


def blocksize_is_subset(blocksize: int, sample_rate: int) -> bool:
    """format.c:218-240."""
    if blocksize > 16384:
        return False
    if sample_rate <= 48000 and blocksize > 4608:
        return False
    return True


def max_rice_partition_order_from_blocksize(blocksize: int) -> int:
    """format.c:529-539: number of trailing zero bits of blocksize, capped."""
    max_order = 0
    while blocksize > 0 and not (blocksize & 1):
        max_order += 1
        blocksize >>= 1
    return min(MAX_RICE_PARTITION_ORDER, max_order)


def max_rice_partition_order_limited(limit: int, blocksize: int,
                                     predictor_order: int) -> int:
    """format.c:541-553: additionally require each partition to hold more
    samples than the predictor order."""
    max_order = min(limit, max_rice_partition_order_from_blocksize(blocksize))
    while max_order > 0 and (blocksize >> max_order) <= predictor_order:
        max_order -= 1
    return max_order
