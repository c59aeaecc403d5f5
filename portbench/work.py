"""The yardstick of the kernel layer: the least time the card could take
for the work of each encode kernel (K1, K4-K12), from shapes and the
benchmark's own parse of the written stream.

A frozen copy of chip_smoke.py's `bound`, `k1_work`, `k4_work`,
`k5_work` and `stage_work`, restated so that it reads no object of the
program: a call's shape (frames B, channels C, block size N, the uploaded
sample width), the configuration's own counts (channel candidates,
apodizations and windows, LPC candidates, orders, partitions) and the
parse (subframes with residuals, verbatim subframes, LPC subframes, the
sum of 2^partition-order, frame bytes).  Each input is counted read once
and each output written once; the operations at the per-item rates
chip_smoke.py states.  Where the stream cannot show a count (the search's
candidate orders, which candidates of the four channel rows carry
residuals), the term is left out or counted over the written subframes
only, so a bound is never above the work it stands for.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12

MAX_LPC_ORDER = 32
HEAD_FIELDS = 11           # header, 7 UTF-8 slots, two tails, CRC-8 slot

K1_OPS_PER_FIELD = 16
K4_OPS_PER_FIELD = 12
K4_OPS_PER_SAMPLE = 20
K5_OPS_PER_BYTE = 6
K6_OPS_PER_STEP = 8
K6_OPS_PER_ESTIMATE = 15
K6_OPS_PER_CANDIDATE = 40
K7_OPS_PER_SAMPLE = 4
K7_OPS_PER_SAMPLE_K = 3
K7_OPS_PER_NODE_K = 6
K8_OPS_PER_FIXED_SAMPLE = 4
K8_OPS_PER_LPC_SAMPLE = 5
K9_OPS_PER_SAMPLE = 2
K9_OPS_PER_CANDIDATE = 30
K10_OPS_PER_SAMPLE = 14
N_PREC = 5                 # the precisions -p tries

# the kernels by their name in a trace (a CUDA function name holds it)
KERNELS = {"K1": "pack_fields64_kernel", "K4": "assemble_fields_kernel",
           "K5": "frame_crc_kernel", "K6": "lpc_coeffs_kernel",
           "K7": "rice_cost_kernel", "K8": "candidate_residuals_kernel",
           "K9": "select_realize_kernel",
           "K10": "channel_candidates_kernel", "K11": "window_autoc_kernel",
           "K12": "assign_channels_kernel"}
# the program's launch counter of each (flac_tpu_torch.encoder's
# COUNTED_KERNELS keys)
COUNTERS = {"K1": "pack_fields64", "K4": "assemble_fields",
            "K5": "frame_crc", "K6": "lpc_coeffs", "K7": "rice_cost",
            "K8": "candidate_residuals", "K9": "select_realize",
            "K10": "channel_candidates", "K11": "window_autoc",
            "K12": "assign_channels"}


def bound(nbytes: float, nops: float) -> dict:
    """The least time for work that must move `nbytes` and do `nops`
    operations: the larger of the two times at the data sheet's rates."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / NON_TENSOR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "operations": nops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# ---------------------------------------------------------------------------
# the configuration's counts
# ---------------------------------------------------------------------------

def _tukey(L: int, p: float) -> np.ndarray:
    """libFLAC window.c's tukey (float32), for the windows' support."""
    if p <= 0.0:
        return np.ones(L, np.float32)
    Np = int(np.float32(p) / 2.0 * L) - 1
    w = np.ones(L, dtype=np.float64)
    if Np > 0:
        n = np.arange(Np + 1, dtype=np.float64)
        w[:Np + 1] = 0.5 - 0.5 * np.cos(np.pi * n / Np)
        w[L - Np - 1:] = 0.5 - 0.5 * np.cos(np.pi * (n + Np) / Np)
    return w.astype(np.float32)


def _partial(root: np.ndarray, part_size: int, shift: int) -> np.ndarray:
    """The full-length form of libFLAC's partial window (lpc.c:81-93): the
    root window's first and last part_size samples at [shift, shift +
    2 * part_size), zero elsewhere."""
    L = len(root)
    w = np.zeros(L, dtype=np.float32)
    if part_size + shift >= L:
        return w
    w[shift:shift + part_size] = root[:part_size]
    n2 = min(part_size, L - part_size - shift)
    w[shift + part_size:shift + part_size + n2] = root[L - part_size:
                                                       L - part_size + n2]
    return w


def window_bank(spec: str, N: int) -> tuple[list, int]:
    """(windows, apodization rows) of one apodization spec of libFLAC's:
    "tukey(p)" or "subdivide_tukey(parts[/p])", whose depth 2 adds its
    partial windows and each deeper depth its partial and punch-out
    rows (stream_encoder.c:4293-4391)."""
    name, arg = spec.split("(")
    args = [float(a) for a in arg.rstrip(")").split("/")]
    if name == "tukey":
        return [_tukey(N, args[0])], 1
    if name != "subdivide_tukey":
        raise ValueError(f"apodization {spec!r} is not in the yardstick")
    parts, p = int(args[0]), (args[1] if len(args) > 1 else 0.5)
    root = _tukey(N, p / parts)      # libFLAC scales p by the parts
    windows, rows = [root], 1
    for b in range(2, parts + 1):
        if N // b <= MAX_LPC_ORDER:
            break
        for c in range(b):
            windows.append(_partial(root, N // b // 2, (c * N) // b))
            rows += 2 if b > 2 else 1
    return windows, rows


@dataclass(frozen=True)
class Encoding:
    """What a configuration makes each encode call do."""
    channels: int
    bps: int
    max_lpc_order: int
    max_partition_order: int
    apodizations: tuple
    mid_side: bool
    loose: bool = False
    exhaustive: bool = False
    precision_search: bool = False

    @property
    def CH(self) -> int:           # channel candidate rows a frame
        return 4 if self.stereo_ms else self.channels

    @property
    def stereo_ms(self) -> bool:
        return self.channels == 2 and self.mid_side

    @property
    def xs(self) -> int:           # bytes of a channel candidate sample
        return 8 if self.bps + (1 if self.stereo_ms else 0) > 32 else 4

    @property
    def rice_params(self) -> int:
        return 31 if self.bps > 16 else 15

    def po_limit(self, N: int) -> int:
        """The partition order cap of a block of N samples (libFLAC's
        blocksize divisibility rule)."""
        po = self.max_partition_order
        while po > 0 and N % (1 << po):
            po -= 1
        return po

    def bank(self, N: int) -> tuple[list, int]:
        windows, rows = [], 0
        for spec in self.apodizations:
            w, r = window_bank(spec, N)
            windows += w
            rows += r
        return windows, rows

    def lpc_candidates(self, N: int) -> int:
        A = self.bank(N)[1]
        AC = A * (self.max_lpc_order if self.exhaustive else 1)
        return AC * (N_PREC if self.precision_search else 1)

    def quad(self, N: int) -> bool:
        """Whether a call of N-sample frames takes the quad layout (the one
        K1 deposits)."""
        m_min = max(N >> self.po_limit(N), 1)
        return (self.bps + (1 if self.stereo_ms else 0) <= 32
                and self.bps <= 26 and N % 4 == 0 and m_min % 4 == 0)

    def fields(self, N: int, quad: bool) -> int:
        """F, the field slots of a frame in the assembled layout."""
        max_po = self.po_limit(N)
        m_min = max(N >> max_po, 1)
        wide = self.bps + (1 if self.stereo_ms else 0) > 32
        per = 2 * m_min if wide else (m_min // 4 if quad else m_min)
        WS = 2 * MAX_LPC_ORDER if wide else MAX_LPC_ORDER
        G = N // m_min
        per_channel = 1 + 1 + WS + 1 + MAX_LPC_ORDER + 1 + 1 + G * (1 + per)
        return HEAD_FIELDS + self.channels * per_channel + 2


@dataclass
class Parse:
    """Sums over a call's frames of what the written stream shows."""
    res_subframes: int = 0        # FIXED and LPC subframes
    verbatim_subframes: int = 0
    lpc_subframes: int = 0
    partitions: int = 0           # sum of 2^po over res_subframes
    crc_bytes: int = 0            # sum of (frame bytes - 2)
    words: int = 0                # sum of ceil(frame bits / 32)


@dataclass
class Call:
    """One encode program call: B frames of N samples, the upload's
    sample width, whether the quad layout's deposit (K1) runs."""
    B: int
    N: int
    in_bytes: int
    quad: bool
    parse: Parse = field(default_factory=Parse)


def _k11_products(windows: list, N: int, O: int) -> int:
    """Per row: the products d[n] * d[n + l] (n + l < N, l <= O) of every
    window whose first factor lies in a block of 128 windowed samples
    that are not all zero (the traffic has no digital silence, so a
    block is live where its window is)."""
    K = -(-N // 128)
    n = np.arange(K * 128).reshape(K, 128)
    per_block = sum(((n + lag) < N).sum(axis=1) for lag in range(O + 1))
    total = 0
    for w in windows:
        live = np.pad(w != 0, (0, K * 128 - N)).reshape(K, 128).any(axis=1)
        total += int((per_block * live).sum())
    return total


def call_work(enc: Encoding, call: Call) -> dict:
    """{kernel: (bytes, operations)} of one encode program call."""
    B, N, C, CH, xs = call.B, call.N, enc.channels, enc.CH, enc.xs
    pr = call.parse
    rows = B * CH
    O = enc.max_lpc_order
    max_po = enc.po_limit(N)
    P = 1 << max_po
    AC = enc.lpc_candidates(N) if O else 0
    out = {}
    # K10: the upload read once, the candidates, bps and wasted bits (and
    # the loose assignment) written once
    out["K10"] = (B * C * N * call.in_bytes + rows * N * xs + 2 * rows * 4
                  + (B * 4 if enc.loose else 0),
                  B * N * C * K10_OPS_PER_SAMPLE // 2)
    if O:
        windows, A = enc.bank(N)
        W = len(windows)
        # K11: x, the windows and the combine read once, the
        # autocorrelations written once; two operations an fma
        out["K11"] = (rows * N * xs + W * N * 4 + A * W * 8
                      + rows * A * (O + 1) * 8,
                      2 * rows * _k11_products(windows, N, O))
        # K6: the autocorrelations and bps read once, each candidate's
        # coefficients, shift, order, precision and flag written once; one
        # recursion a problem and its orders' estimates (the quantizer's
        # steps to each candidate's order are not in the stream: left out)
        problems = rows * A
        ests = 1 if enc.exhaustive else 2
        out["K6"] = (rows * A * (O + 1) * 8 + rows * 4
                     + rows * AC * (32 * 4 + 3 * 4 + 1),
                     problems * sum(2 * i + K6_OPS_PER_STEP for i in range(O))
                     + problems * O * ests * K6_OPS_PER_ESTIMATE
                     + rows * AC * K6_OPS_PER_CANDIDATE)
    # K8: x, coefficients, shifts, orders, bps read once; every candidate's
    # residual row, orders and flags written once (taps to the candidates'
    # orders are not in the stream: left out)
    out["K8"] = (rows * N * xs + rows * AC * (32 + 2) * 4 + rows * 4
                 + rows * (5 + AC) * (N + 1) * 4 + rows * (5 + AC),
                 rows * N * 5 * K8_OPS_PER_FIXED_SAMPLE
                 + rows * AC * N * K8_OPS_PER_LPC_SAMPLE)
    # K7: every candidate row read once, its bits, parameters and flags
    # written once
    r7, L7, K7 = rows * (5 + AC), max_po + 1, enc.rice_params
    out["K7"] = (r7 * N * 4 + r7 * 4 + r7 * L7 * (4 + 1) + r7 * L7 * P * 4,
                 r7 * (N * (K7_OPS_PER_SAMPLE + K7 * K7_OPS_PER_SAMPLE_K)
                       + (2 * P - 1) * K7 * K7_OPS_PER_NODE_K))
    # K9: x once, each candidate's costs and fields, the winners' residual
    # rows (counted over the written subframes only), one parameter and
    # coefficient row a winner; each output written once
    C9, L9 = 5 + AC, max_po + 1
    out["K9"] = (rows * N * xs
                 + rows * (C9 * L9 * 4 + C9 * 4 + 5 + AC * 6 + 8)
                 + pr.res_subframes * N * 4 + rows * (P * 4 + 1)
                 + pr.lpc_subframes * (32 + 2) * 4
                 + rows * (N * 4 + P * 4 + 32 * 4 + 32 * xs + 6 * 4 + 1),
                 rows * (N * K9_OPS_PER_SAMPLE + C9 * K9_OPS_PER_CANDIDATE))
    if enc.stereo_ms:
        per_channel = (8 * 4 + 1 + 32 * 4 + 32 * xs + P * 4 + N * 4
                       + N * xs)
        out["K12"] = (B * 4 * 4 + (B * 4 if enc.loose else 0)
                      + 2 * 2 * B * per_channel + B * 4, B * 2 * 20)
    # K4: the channel scalars, warm-up and coefficients of every subframe,
    # the partition parameters and residuals of FIXED and LPC subframes,
    # the samples of VERBATIM ones, the assignment and frame numbers read
    # once; the field lists and the three [B] outputs written once
    F = enc.fields(N, call.quad)
    out["K4"] = (B * C * (7 * 4 + 1 + 32 * 4 + 32 * 4) + pr.partitions * 4
                 + pr.res_subframes * N * 4 + pr.verbatim_subframes * N * 4
                 + B * (4 + 8) + B * F * 16 + B * 9,
                 B * F * K4_OPS_PER_FIELD
                 + pr.res_subframes * N * K4_OPS_PER_SAMPLE)
    if call.quad:
        # K1: each field read once (zeros, payload, bits), each frame's
        # words written once (the stream's words: the padded rows are the
        # program's layout) and its length
        out["K1"] = (B * F * (4 + 8 + 4) + pr.words * 4 + B * 4,
                     B * F * K1_OPS_PER_FIELD)
    # K5: the bytes under the CRCs read once, the length and header
    # length, three CRC bytes written
    out["K5"] = (pr.crc_bytes + B * 8 + B * 3, pr.crc_bytes * K5_OPS_PER_BYTE)
    return out


def window_bounds(enc: Encoding, calls: list) -> dict:
    """{kernel: bound ms} over a window's calls: each kernel's bytes and
    operations summed, then one bound (never above the sum of the
    calls' own bounds)."""
    tot: dict = {}
    for call in calls:
        for k, (b, o) in call_work(enc, call).items():
            tb, to = tot.get(k, (0, 0))
            tot[k] = (tb + b, to + o)
    return {k: bound(b, o) for k, (b, o) in tot.items()}


def call_launches(enc: Encoding, calls: list) -> dict:
    """{kernel: launches} the calls make by the yardstick's model: each
    kernel whose work a call has, once a call."""
    out: dict = {}
    for call in calls:
        for k in call_work(enc, call):
            out[k] = out.get(k, 0) + 1
    return out
