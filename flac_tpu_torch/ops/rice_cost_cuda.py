"""Kernel K7: the encoder's Rice cost table as a hand-written CUDA kernel.

Replaces flac_tpu/ops/rice.py partition_cost_table (:66) with zigzag (:40)
and flac_tpu/models/subframe.py _rice_cost (:60) and _max_po_limit (:53),
which XLA fuses into the jitted encode_batch and the port ran op by op:
the int32 residuals zigzagged into an int64 tensor (50 MB at -5), then
kmax + 1 shift-and-sum passes over it, the pair-merges, argmins and
escapes of every partition order.  The source is csrc/rice_cost.cu: a CTA
a (frame, channel candidate, candidate) row that reads its residuals once
and counts, for each partition, how many zigzagged residuals have each
bit set (a warp's 32 x 32 bit transpose and __popc); every shifted sum
S_k follows from the 32 counts, and as the cost is convex in k the first
argmin is the first k where it stops falling, so each node of the
partition tree (every partition order the configuration allows) is
costed without a search over k (see the source for the design).  Every
cost is an integer, so it equals the plain version (models/subframe.py
_rice_cost_plain) bit for bit.

Bound: at -5 a batch is 1536 rows of 4096 int32 residuals: 25.2 MB read
once (and ~1.2 MB of parameters written), ~7.9 us of HBM time at 3.35 TB/s
(the NVIDIA H100 SXM data sheet's rate).  chip_smoke.py measures it.

`subframe._rice_cost` dispatches on the residuals' device: the plain
version for CPU tensors, `rice_cost` here for CUDA tensors (it launches or
raises; there is no fallback).  One launch a call, RICE2 configurations
included (both tables in the same pass).  `launches`, `captured` and
`count_replay` count launches as pack_cuda's do, through the encoder's
CUDA graphs too.  The wrapper allocates its outputs (and, with RICE2, the
5-bit table's scratch) with torch and reads nothing back, so it runs
inside a capture; the library loads on a key's first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

SOURCE = "flac_tpu_torch/csrc/rice_cost.cu"
REPLACES = "flac_tpu/ops/rice.py:66"     # partition_cost_table, with :40
_LIB_NAME = "rice_cost"
MAX_N = 1 << 15          # the plain version's blocksize cap
MAX_PO = 15              # format's partition-order cap

launches = 0          # kernel launches of K7 in this process
captured = 0          # K7 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signature."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_rice_cost.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flac_rice_cost.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_arguments(res, order, N: int, max_po: int) -> None:
    """Raise ValueError unless res is an [..., N] int32 tensor and order an
    int32 tensor of its leading shape on its device, with N <= 2^15 a
    multiple of 2^max_po and 0 <= max_po <= 15."""
    if res.dtype != torch.int32 or res.ndim < 1 or res.shape[-1] != N:
        raise ValueError(f"rice_cost: res must be an [..., {N}] int32 "
                         f"tensor, not {res.dtype} {tuple(res.shape)}")
    if order.device != res.device or order.dtype != torch.int32 \
            or tuple(order.shape) != tuple(res.shape[:-1]):
        raise ValueError(f"rice_cost: order must be {list(res.shape[:-1])} "
                         f"int32 on {res.device}, not {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")
    if not 0 <= max_po <= MAX_PO or not 0 < N <= MAX_N \
            or (N >> max_po) << max_po != N:
        raise ValueError(f"rice_cost: N={N} and max_po={max_po}: want "
                         f"0 <= max_po <= {MAX_PO} and N <= {MAX_N} a "
                         f"multiple of 2^max_po")


def rice_cost(res, order, N: int, max_po: int, cfg):
    """Launch K7: subframe._rice_cost on a CUDA device.  Returns (bits
    [..., L] int32, params [..., L, P] int32, rice2 [..., L] bool), L =
    max_po + 1, P = 2^max_po."""
    global launches, captured
    if res.device.type != "cuda":
        raise ValueError("rice_cost: res is not on a GPU")
    check_arguments(res, order, N, max_po)
    lead = tuple(res.shape[:-1])
    L, P = max_po + 1, 1 << max_po
    dev = res.device
    bits = torch.empty(lead + (L,), dtype=torch.int32, device=dev)
    ks = torch.empty(lead + (L, P), dtype=torch.int32, device=dev)
    rice2 = torch.empty(lead + (L,), dtype=torch.bool, device=dev)
    rows = bits.numel() // L
    if rows == 0:
        return bits, ks, rice2
    rice2_mode = cfg.rice_param_limit > 15
    ks5 = torch.empty_like(ks) if rice2_mode else None
    res = res.contiguous()
    order = order.contiguous()
    with torch.cuda.device(dev):
        lib = _library()
        kernels.check(lib.flac_rice_cost(
            res.data_ptr(), order.data_ptr(), bits.data_ptr(),
            ks.data_ptr(), ks5.data_ptr() if rice2_mode else None,
            rice2.data_ptr(), rows, N, max_po,
            cfg.min_residual_partition_order, int(rice2_mode),
            int(cfg.do_escape_coding),
            torch.cuda.current_stream().cuda_stream), "flac_rice_cost launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return bits, ks, rice2


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K7 launches was replayed: they ran."""
    global launches
    launches += n
