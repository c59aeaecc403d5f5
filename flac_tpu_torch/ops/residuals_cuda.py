"""Kernel K8: the encoder's candidate residuals as a hand-written CUDA
kernel.

Replaces flac_tpu/ops/fixed.py fixed_residuals_all (:44) and
flac_tpu/ops/lpc.py lpc_residual (:315, its "i32" and "f64" modes with
the range analysis of :344-349), with the masks, the wide fixed path and
f_ok of flac_tpu/models/subframe.py:130-146, the LPC residual call at
:224-227 and the res_all/order_all concatenation at :240-241, which XLA
fuses into the jitted encode_batch and the port ran op by op: some
thirty small kernels a -5 batch (a shifted copy, a product and a sum a
tap, the masks, the casts, the concatenation).  The source is
csrc/candidate_residuals.cu: a CTA of 128 threads a (frame and channel
candidate, span of 512 samples) computes every candidate row of that
span: the span and its 32-sample history are staged once into shared
memory beside the candidates' coefficients; a thread takes 4 consecutive
samples, the fixed orders from its window in registers, the LPC
candidates in chunks of up to 5, taps outer and candidates inner (one
shared load of 4 history samples and one broadcast load of 4
coefficients a candidate feed 16 multiply-adds), and writes each row's 4
residuals with one 16-byte store.  The range flags of the wide fixed rows
and the "f64" mode are ORs over a row's spans: those forms launch a row's
CTAs as a thread block cluster (up to 8) that ORs them in rank 0's shared
memory.  The arithmetic is the plain version's (models/subframe.py
candidate_residuals_plain): wrapping int32 in "i32" mode and for narrow
fixed rows, int64 where the plain version's float64 is exact (the "f64"
mode, the wide fixed rows; on int32 signals a tap is one 32 x 32 ->
64-bit multiply-add), so the two agree bit for bit on every row whose
flag holds.

Bound: at -5 a batch reads x ([64, 4, 4096] int32, 4.2 MB) and writes
res_all ([64, 4, 6, 4096] int32, 25.2 MB): ~8.8 us at 3.35 TB/s (the
NVIDIA H100 SXM data sheet's rate); at -8 it writes 14 rows a channel
candidate (58.7 MB), ~18.8 us.  chip_smoke.py measures it.

`subframe.candidate_residuals` dispatches on x's device: the plain version
for CPU tensors, `candidate_residuals` here for CUDA tensors (it launches
or raises; there is no fallback).  One launch a call.  `launches`,
`captured` and `count_replay` count launches as pack_cuda's do, through
the encoder's CUDA graphs too.  The wrapper allocates its outputs with
torch and reads nothing back, so it runs inside a capture; the library
loads on a key's first, uncaptured call.

The rule for a row whose flag is false (a wide fixed row with f_ok
false, an "f64" LPC row with fit_ok false): its residuals have no defined
value.  The plain version casts out-of-range float64 values to int32
(what the cast gives there depends on the device); K8 writes the low 32
bits of the exact int64 residual.  The search never reads such a row (its
candidate is BIG), and every comparison holds such rows by their flags
only (`comparable_rows`).  An "i32" row whose range analysis fails
(fit_ok false) wraps as the plain version's int32 arithmetic wraps, and
is equal everywhere.
"""

from __future__ import annotations

import ctypes

import torch

from .. import format as fmt
from .. import kernels

SOURCE = "flac_tpu_torch/csrc/candidate_residuals.cu"
REPLACES = "flac_tpu/ops/lpc.py:315"     # lpc_residual, with fixed.py:44
_LIB_NAME = "candidate_residuals"
MAX_N = 1 << 15          # the plain version's blocksize cap
FIXED_ORDERS = 5         # fixed orders 0..4 (FIXED in the source)
THREADS = 128            # threads a CTA (THREADS in the source)
SPAN = 512               # samples a span (SPAN in the source)
RING = 4                 # spans staged ahead, at most (RING)
CLUSTER = 8              # CTAs a row, at most (CLUSTER)
BLOCK = 48               # candidates a coefficient table (BLOCK)
LPC_MODES = ("i32", "f64")

launches = 0          # kernel launches of K8 in this process
captured = 0          # K8 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_candidate_residuals.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.flac_candidate_residuals.restype = ctypes.c_int
        lib.flac_candidate_residuals_grid.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.flac_candidate_residuals_grid.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_taps(N: int, max_order: int) -> int:
    """The taps the plain version's loop runs (lpc_residual's max_j): a
    candidate's own loop stops at the smaller of this and its order."""
    return min(fmt.MAX_LPC_ORDER, max(N - 1, 1), max(max_order, 1))


def ctas(rows: int, N: int, slots: int) -> tuple:
    """The source's grid_of: (CTAs a row, spans of SPAN samples a CTA).
    A row takes up to CLUSTER CTAs, halved (rounding up) while `rows`
    rows would pass the `slots` CTAs the card holds at once, each CTA a
    run of consecutive spans, and only CTAs that have one; where a row's
    flags are ORed over its spans (the wide fixed path, the "f64" mode)
    its CTAs form one thread block cluster."""
    spans = -(-N // SPAN)
    p = min(spans, CLUSTER)
    while p > 1 and rows * p > slots:
        p = (p + 1) // 2
    per = -(-spans // p)
    return -(-spans // per), per


def grid(x, fixed_wide: bool, lpc_mode: str) -> tuple:
    """(CTAs a row, CTAs of the form an SM holds) of a launch on x
    [B, CH, N] on the current CUDA device, from the library's own rule
    (flac_candidate_residuals_grid)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(x.device):
        kernels.check(_library().flac_candidate_residuals_grid(
            x.shape[0] * x.shape[1], x.shape[2],
            int(x.dtype == torch.int64), int(fixed_wide),
            int(lpc_mode == "f64"), ctypes.addressof(out)),
            "flac_candidate_residuals_grid")
    return out[0], out[1]


def comparable_rows(f_ok, fit_ok, fixed_wide: bool, lpc_mode: str):
    """[B, CH, 5 + AC] bool: the rows of res_all whose residuals are
    defined, so that K8 and its plain version (or flac_tpu's) must agree
    on them: every narrow fixed row and every "i32" row, and a wide fixed
    or "f64" row where its flag holds."""
    fixed = f_ok if fixed_wide else torch.ones_like(f_ok)
    lpc = fit_ok if lpc_mode == "f64" else torch.ones_like(fit_ok)
    return torch.cat([fixed, lpc], dim=-1)


def same_outputs(got, want, fixed_wide: bool, lpc_mode: str) -> bool:
    """Whether two candidate_residuals results agree: order_all, f_ok and
    fit_ok equal, and res_all equal on every row `comparable_rows` takes
    (by want's flags)."""
    if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
        return False
    rows = comparable_rows(want[2], want[3], fixed_wide, lpc_mode)
    return got[0].shape == want[0].shape \
        and torch.equal(got[0][rows], want[0][rows])


def check_arguments(x, qc, qshift, cand_order, bps_eff, fixed_wide: bool,
                    lpc_mode: str, max_order: int) -> None:
    """Raise ValueError unless x is a [B, CH, N] int32 (or, with the wide
    fixed path and "f64", int64) tensor with 1 <= N <= 2^15, qc a
    [B, CH, AC, 32] int32 tensor, qshift and cand_order [B, CH, AC] int32,
    bps_eff [B, CH] int32, all on x's device, lpc_mode "i32" or "f64" and
    max_order in 0..32."""
    if x.ndim != 3 or x.dtype not in (torch.int32, torch.int64) \
            or not 1 <= x.shape[-1] <= MAX_N:
        raise ValueError(f"candidate_residuals: x must be a [B, CH, N] "
                         f"int32 or int64 tensor with 1 <= N <= {MAX_N}, "
                         f"not {x.dtype} {tuple(x.shape)}")
    if lpc_mode not in LPC_MODES:
        raise ValueError(f"candidate_residuals: unknown mode {lpc_mode}")
    if x.dtype == torch.int64 and not (fixed_wide and lpc_mode == "f64"):
        raise ValueError("candidate_residuals: an int64 x takes the wide "
                         "fixed path and the \"f64\" mode only")
    if not 0 <= max_order <= fmt.MAX_LPC_ORDER:
        raise ValueError(f"candidate_residuals: max_order {max_order} is "
                         f"not in 0..{fmt.MAX_LPC_ORDER}")
    B, CH = x.shape[:2]
    if qc.ndim != 4 or tuple(qc.shape[:2]) != (B, CH) \
            or qc.shape[3] != fmt.MAX_LPC_ORDER:
        raise ValueError(f"candidate_residuals: qc must be [{B}, {CH}, AC, "
                         f"{fmt.MAX_LPC_ORDER}], not {tuple(qc.shape)}")
    want = {"qc": (qc, tuple(qc.shape)),
            "qshift": (qshift, tuple(qc.shape[:3])),
            "cand_order": (cand_order, tuple(qc.shape[:3])),
            "bps_eff": (bps_eff, (B, CH))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != x.device:
            raise ValueError(f"candidate_residuals: {name} must be "
                             f"{list(shape)} int32 on {x.device}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def launch_arguments(x, qc, qshift, cand_order, bps_eff, fixed_wide: bool,
                     lpc_mode: str, max_order: int) -> tuple:
    """(the outputs res_all, order_all, f_ok, fit_ok, allocated on x's
    device; the C entry point's arguments but the stream) of a K8 launch
    on checked, contiguous arguments."""
    B, CH, N = x.shape
    AC = qc.shape[2]
    C = FIXED_ORDERS + AC
    dev = x.device
    res = torch.empty((B, CH, C, N), dtype=torch.int32, device=dev)
    order_all = torch.empty((B, CH, C), dtype=torch.int32, device=dev)
    f_ok = torch.empty((B, CH, FIXED_ORDERS), dtype=torch.bool, device=dev)
    fit_ok = torch.empty((B, CH, AC), dtype=torch.bool, device=dev)
    out = (res, order_all, f_ok, fit_ok)
    args = (x.data_ptr(), qc.data_ptr(), qshift.data_ptr(),
            cand_order.data_ptr(), bps_eff.data_ptr(),
            *(t.data_ptr() for t in out), B * CH, AC, N,
            max_taps(N, max_order), int(x.dtype == torch.int64),
            int(fixed_wide), int(lpc_mode == "f64"))
    return out, args


def candidate_residuals(x, qc, qshift, cand_order, bps_eff,
                        fixed_wide: bool, lpc_mode: str, max_order: int):
    """Launch K8: subframe.candidate_residuals on a CUDA device.  Returns
    (res_all [B, CH, 5 + AC, N] int32, order_all [B, CH, 5 + AC] int32,
    f_ok [B, CH, 5] bool, fit_ok [B, CH, AC] bool)."""
    global launches, captured
    if x.device.type != "cuda":
        raise ValueError("candidate_residuals: x is not on a GPU")
    check_arguments(x, qc, qshift, cand_order, bps_eff, fixed_wide,
                    lpc_mode, max_order)
    x, qc, qshift = x.contiguous(), qc.contiguous(), qshift.contiguous()
    cand_order, bps_eff = cand_order.contiguous(), bps_eff.contiguous()
    out, args = launch_arguments(x, qc, qshift, cand_order, bps_eff,
                                 fixed_wide, lpc_mode, max_order)
    if x.shape[0] * x.shape[1] == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _library()
        kernels.check(lib.flac_candidate_residuals(
            *args, torch.cuda.current_stream().cuda_stream),
            "flac_candidate_residuals launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K8 launches was replayed: they ran."""
    global launches
    launches += n
