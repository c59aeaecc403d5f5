"""Kernel K6: the encoder's LPC coefficient stage as a hand-written CUDA
kernel.

Replaces flac_tpu/ops/lpc.py levinson_all_orders (:149),
estimate_best_order (:205) and quantize_coefficients (:257), with the
candidate grid around them (flac_tpu/models/subframe.py:155-218: -e, -p,
the "don't even try" estimate, the precision clamp), which XLA fuses into
the jitted encode_batch and the port ran op by op: some 900 small kernels
a -5 batch, each one serial step over a few hundred values.  The source
is csrc/lpc_coeffs.cu: a group of `lanes(O)` lanes a (frame and channel
candidate, apodization) problem in CTAs of one warp; every lane runs the
one recursion, unrolled through a template on the order, and lane i % G
keeps order i + 1's error and coefficients; the lanes estimate their
orders side by side, a shuffle butterfly takes the first-index argmin,
and the candidates' precisions are shared out over the lanes.  Every
float64 step is rounded as the plain version (models/subframe.py
lpc_candidates_plain) rounds it, so the two agree bit for bit.

Bound: a -5 batch of 64 stereo frames is 256 problems of order 8 (~20 KB
of autocorrelations in, ~40 KB out): the card moves that in ~0.02 us at
3.35 TB/s (the NVIDIA H100 SXM data sheet's rate).  A launch is one
problem's chain of dependent float64 operations (`chain_ops`: the
recursion, an estimate, the quantizer up to the candidate's order) and
the launch itself.  chip_smoke.py measures it, with the chain's floor
from each operation's dependent latency (`op_cycles`).

`subframe.lpc_candidates` dispatches on the tensors' device: the plain
version for CPU tensors, `lpc_candidates` here for CUDA tensors (it
launches or raises; there is no fallback).  `launches`, `captured` and
`count_replay` count launches as pack_cuda's do, through the encoder's
CUDA graphs too.  The wrapper allocates its outputs with torch and reads
nothing back, so it runs inside a capture; the library loads on a key's
first, uncaptured call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import format as fmt
from .. import kernels

SOURCE = "flac_tpu_torch/csrc/lpc_coeffs.cu"
REPLACES = "flac_tpu/ops/lpc.py:149"     # levinson_all_orders, with :205, :257
_LIB_NAME = "lpc_coeffs"
N_PREC = fmt.MAX_QLP_COEFF_PRECISION - fmt.MIN_QLP_COEFF_PRECISION + 1
TEMPLATE_ORDERS = (6, 8, 12, 32)   # the source's instantiations
CTA = 32                           # threads a CTA (CTA in the source)
# the probe's operations (lpc_op_probe_kernel), in its order
PROBE_OPS = ("add", "div", "log2", "floor", "mul")

launches = 0          # kernel launches of K6 in this process
captured = 0          # K6 launches recorded into CUDA graphs (not run)
_lib = None


def _library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signatures."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_lpc_coeffs.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.flac_lpc_coeffs.restype = ctypes.c_int
        lib.flac_lpc_op_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.flac_lpc_op_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


def candidates(A: int, O: int, cfg) -> int:
    """AC, the LPC candidates a (frame, channel candidate): A apodizations,
    times O orders with -e, times the precisions with -p."""
    AC = A * (O if cfg.do_exhaustive_model_search else 1)
    return AC * (N_PREC if cfg.do_qlp_coeff_prec_search else 1)


def template_order(O: int) -> int:
    """The instantiation a launch of order O takes (the source's
    dispatch)."""
    return next(t for t in TEMPLATE_ORDERS if O <= t)


def lanes(O: int) -> int:
    """Lanes a problem at order O (the source's lanes_for of its
    template order)."""
    t = template_order(O)
    return 8 if t <= 8 else 16 if t <= 16 else 32


def ctas(problems: int, O: int) -> int:
    """CTAs a launch of `problems` problems of order O."""
    per = CTA // lanes(O)
    return -(-problems // per)


def chain_ops(O: int, order: int) -> dict:
    """Dependent float64 operations, by kind, on the critical path of a
    problem of order O whose longest candidate has `order` coefficients:
    the recursion once (step 0: an add and the division; step 1: the
    product, two adds, the division; step i >= 2: the update's multiply
    and add, the product, i adds of the inner sum, the autocorrelation's
    add, the division), the last error (3), the last order's estimate (its
    multiply, log2, halving, clamp and one more step: 5 and a log2), then
    the quantizer: the max over the order as a tree, 3 steps to the scale
    (the exponent read from the bits), and each coefficient's error
    feedback (the add, the rounding add, floor, the sign, two clamps, the
    subtraction).  Multiplies, compares and selects count as adds; the
    shuffles of the order guess are left out."""
    adds = (1 + (3 if O > 1 else 0) + sum(i + 4 for i in range(2, O))
            + 3 + 5 + (order - 1).bit_length() + 3 + 6 * order)
    return {"add": adds, "div": O, "log2": 1, "floor": order}


def chain_cycles(ops: dict, cycles: dict) -> float:
    """Cycles of a chain_ops count at the probe's cycles an operation."""
    return sum(n * cycles[kind] for kind, n in ops.items())


def check_arguments(autoc, bps_eff, N: int) -> None:
    """Raise ValueError unless autoc is a [B, CH, A, O+1] float64 tensor
    with 1 <= O <= min(32, N - 1) and bps_eff a [B, CH] int32 tensor on its
    device."""
    if autoc.dtype != torch.float64 or autoc.ndim != 4:
        raise ValueError(f"lpc_candidates: autoc must be a [B, CH, A, O+1] "
                         f"float64 tensor, not {autoc.dtype} "
                         f"{tuple(autoc.shape)}")
    O = autoc.shape[-1] - 1
    if not 1 <= O <= min(fmt.MAX_LPC_ORDER, N - 1):
        raise ValueError(f"lpc_candidates: order {O} is not in 1.."
                         f"{min(fmt.MAX_LPC_ORDER, N - 1)} (N={N})")
    if bps_eff.device != autoc.device or bps_eff.dtype != torch.int32 \
            or tuple(bps_eff.shape) != tuple(autoc.shape[:2]):
        raise ValueError(f"lpc_candidates: bps_eff must be "
                         f"{list(autoc.shape[:2])} int32 on {autoc.device}, "
                         f"not {bps_eff.dtype} {tuple(bps_eff.shape)} on "
                         f"{bps_eff.device}")


def lpc_candidates(autoc, bps_eff, N: int, cfg):
    """Launch K6: subframe.lpc_candidates on a CUDA device.  Returns (qc
    [B, CH, AC, 32] int32, qshift, cand_order, prec [B, CH, AC] int32, ok
    [B, CH, AC] bool)."""
    global launches, captured
    if autoc.device.type != "cuda":
        raise ValueError("lpc_candidates: autoc is not on a GPU")
    check_arguments(autoc, bps_eff, N)
    B, CH, A, O1 = autoc.shape
    O = O1 - 1
    AC = candidates(A, O, cfg)
    dev = autoc.device
    qc = torch.empty((B, CH, AC, fmt.MAX_LPC_ORDER), dtype=torch.int32,
                     device=dev)
    qshift, order, prec = (torch.empty((B, CH, AC), dtype=torch.int32,
                                       device=dev) for _ in range(3))
    ok = torch.empty((B, CH, AC), dtype=torch.bool, device=dev)
    if B * CH == 0:
        return qc, qshift, order, prec, ok
    autoc = autoc.contiguous()
    bps_eff = bps_eff.contiguous()
    with torch.cuda.device(dev):
        lib = _library()
        kernels.check(lib.flac_lpc_coeffs(
            autoc.data_ptr(), bps_eff.data_ptr(), qc.data_ptr(),
            qshift.data_ptr(), order.data_ptr(), prec.data_ptr(),
            ok.data_ptr(), B * CH, A, O, N,
            int(cfg.do_exhaustive_model_search),
            int(cfg.do_qlp_coeff_prec_search), cfg.qlp_coeff_precision,
            torch.cuda.current_stream().cuda_stream), "flac_lpc_coeffs launch")
        if torch.cuda.is_current_stream_capturing():
            captured += 1
        else:
            launches += 1
    return qc, qshift, order, prec, ok


def op_cycles(steps: int = 4096) -> dict:
    """Clock cycles of one dependent operation of each kind of K6's chain
    on the card ({"add", "div", "log2", "floor", "mul"}): one thread,
    `steps` in a row; log2 and floor are probed each with an add after it,
    whose cycles are taken off."""
    sink = torch.empty(1, dtype=torch.float64, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    out = {}
    for op, kind in enumerate(PROBE_OPS):
        kernels.check(_library().flac_lpc_op_probe(
            op, steps, sink.data_ptr(), cycles.data_ptr()),
            "flac_lpc_op_probe")
        out[kind] = int(cycles.item()) / steps
    for kind in ("log2", "floor"):
        out[kind] -= out["add"]
    return out


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K6 launches was replayed: they ran."""
    global launches
    launches += n
