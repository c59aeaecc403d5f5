"""Kernel K9: the encoder's select and realize as a hand-written CUDA
kernel.

Replaces the select of flac_tpu/models/subframe.py search_and_realize:
the verbatim and constant bits (:123-128), the cheapest partition order
of every candidate (`rice_best`, `po_all`, :243-244), the header bits and
`total_all` (:246-258), the first-index argmin over [verbatim, constant,
fixed 0-4, LPC ...] (:260-266), the realize of the winner through
`_select_c` (:92, :275-296: order, residual row, partition order,
parameters, RICE2 flag, coefficients, shift, precision) and the warm-up
(:298-299), which XLA fuses into the jitted encode_batch and the port ran
op by op: some forty small kernels over [B, CH, C] a batch.  The source
is csrc/select_realize.cu: a CTA of 256 threads a (frame, channel
candidate): the constant test over the signal and every candidate's cost
(a thread a candidate) meet in one CTA argmin on (bits, index), the first
index winning ties as torch.argmin does; then the CTA copies the winner's
residual row with 16-byte loads and stores and only its partition order's
parameter row.  Every quantity is an integer, so the kernel equals its
plain version (models/subframe.py select_and_realize_plain) bit for bit.

Bound: at -5 a batch reads the signal once ([64, 4, 4096] int32, 4.2 MB)
and each winner's residual row (at most 4.2 MB) and writes one residual
row a (frame, channel candidate) (4.2 MB): ~3.8 us at 3.35 TB/s (the
NVIDIA H100 SXM data sheet's rate).  chip_smoke.py measures it.

`subframe.select_and_realize` dispatches on x's device: the plain version
for CPU tensors, `select_and_realize` here for CUDA tensors (it launches
or raises; there is no fallback).  One launch a call.  `launches`,
`captured` and `count_replay` count launches as pack_cuda's do, through
the encoder's CUDA graphs too.  The wrapper allocates its outputs with
torch and reads nothing back, so it runs inside a capture; the library
loads on a key's first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import format as fmt
from .. import kernels

SOURCE = "flac_tpu_torch/csrc/select_realize.cu"
REPLACES = "flac_tpu/models/subframe.py:243"   # the select, :123-299
_LIB_NAME = "select_realize"
FIXED_ORDERS = 5
# the order of the tuple `select_and_realize` returns: SubframeChoice's
# fields but wasted and bps_eff, which pass through
OUTPUTS = ("bits", "type_", "order", "qcoeffs", "shift", "precision",
           "warmup", "residual", "po", "params", "use_rice2")

launches = 0          # kernel launches of K9 in this process
captured = 0          # K9 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_select_realize.argtypes = [ctypes.c_void_p] * 25 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flac_select_realize.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_arguments(x, bps_eff, wasted, res_all, order_all, f_ok, cand_ok,
                    fit_ok, prec, qc, qshift, r_bits, r_ks, r_rice2) -> None:
    """Raise ValueError unless the arguments have the shapes and types of
    subframe.select_and_realize's on x's device: x [B, CH, N] int32 or
    int64; bps_eff, wasted [B, CH] int32; res_all [B, CH, C, N] int32,
    order_all [B, CH, C] int32, f_ok [B, CH, 5] bool (C = 5 + AC);
    cand_ok, fit_ok [B, CH, AC] bool; prec, qshift [B, CH, AC] int32; qc
    [B, CH, AC, 32] int32; r_bits [B, CH, C, L] int32, r_ks
    [B, CH, C, L, P] int32, r_rice2 [B, CH, C, L] bool."""
    if x.ndim != 3 or x.dtype not in (torch.int32, torch.int64) \
            or x.shape[-1] < 1:
        raise ValueError(f"select_and_realize: x must be a [B, CH, N] int32 "
                         f"or int64 tensor, not {x.dtype} {tuple(x.shape)}")
    B, CH, N = x.shape
    if qc.ndim != 4 or r_ks.ndim != 5:
        raise ValueError(f"select_and_realize: qc must be [B, CH, AC, 32] "
                         f"and r_ks [B, CH, C, L, P], not "
                         f"{tuple(qc.shape)}, {tuple(r_ks.shape)}")
    AC = qc.shape[2]
    C = FIXED_ORDERS + AC
    L, P = r_ks.shape[3], r_ks.shape[4]
    i32, b8 = torch.int32, torch.bool
    want = {"bps_eff": (bps_eff, (B, CH), i32),
            "wasted": (wasted, (B, CH), i32),
            "res_all": (res_all, (B, CH, C, N), i32),
            "order_all": (order_all, (B, CH, C), i32),
            "f_ok": (f_ok, (B, CH, FIXED_ORDERS), b8),
            "cand_ok": (cand_ok, (B, CH, AC), b8),
            "fit_ok": (fit_ok, (B, CH, AC), b8),
            "prec": (prec, (B, CH, AC), i32),
            "qc": (qc, (B, CH, AC, fmt.MAX_LPC_ORDER), i32),
            "qshift": (qshift, (B, CH, AC), i32),
            "r_bits": (r_bits, (B, CH, C, L), i32),
            "r_ks": (r_ks, (B, CH, C, L, P), i32),
            "r_rice2": (r_rice2, (B, CH, C, L), b8)}
    for name, (t, shape, dtype) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device:
            raise ValueError(f"select_and_realize: {name} must be "
                             f"{list(shape)} {dtype} on {x.device}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if L < 1 or P < 1:
        raise ValueError(f"select_and_realize: L={L} and P={P} must be "
                         "positive")


def select_and_realize(x, bps_eff, wasted, res_all, order_all, f_ok,
                       cand_ok, fit_ok, prec, qc, qshift, r_bits, r_ks,
                       r_rice2) -> tuple:
    """Launch K9: subframe.select_and_realize on a CUDA device.  Returns
    the tensors of OUTPUTS: bits, type_, order, shift, precision, po
    [B, CH] int32, qcoeffs [B, CH, 32] int32, warmup [B, CH, 32] of x's
    dtype, residual [B, CH, N] int32, params [B, CH, P] int32, use_rice2
    [B, CH] bool."""
    global launches, captured
    if x.device.type != "cuda":
        raise ValueError("select_and_realize: x is not on a GPU")
    args = (x, bps_eff, wasted, res_all, order_all, f_ok, cand_ok, fit_ok,
            prec, qc, qshift, r_bits, r_ks, r_rice2)
    check_arguments(*args)
    B, CH, N = x.shape
    AC = qc.shape[2]
    L, P = r_ks.shape[3], r_ks.shape[4]
    dev = x.device

    def new(*shape, dtype=torch.int32):
        return torch.empty((B, CH) + shape, dtype=dtype, device=dev)
    bits, type_, order, shift, precision, po = (new() for _ in range(6))
    qcoeffs = new(fmt.MAX_LPC_ORDER)
    warmup = new(fmt.MAX_LPC_ORDER, dtype=x.dtype)
    residual = new(N)
    params = new(P)
    use_rice2 = new(dtype=torch.bool)
    out = (bits, type_, order, qcoeffs, shift, precision, warmup, residual,
           po, params, use_rice2)
    if B * CH == 0:
        return out
    args = tuple(t.contiguous() for t in args)
    with torch.cuda.device(dev):
        lib = _library()
        kernels.check(lib.flac_select_realize(
            *(t.data_ptr() for t in args), *(t.data_ptr() for t in out),
            B * CH, AC, N, L, P, int(x.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream),
            "flac_select_realize launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K9 launches was replayed: they ran."""
    global launches
    launches += n
