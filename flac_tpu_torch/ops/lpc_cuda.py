"""Kernel K6: the encoder's LPC coefficient stage as a hand-written CUDA
kernel.

Replaces flac_tpu/ops/lpc.py levinson_all_orders (:149),
estimate_best_order (:205) and quantize_coefficients (:257), with the
candidate grid around them (flac_tpu/models/subframe.py:155-218: -e, -p,
the "don't even try" estimate, the precision clamp), which XLA fuses into
the jitted encode_batch and the port ran op by op: some 900 small kernels
a -5 batch, each one serial step over a few hundred values.  The source
is csrc/lpc_coeffs.cu: a thread a (frame and channel candidate,
apodization) problem, looping over its own candidates, every float64 step
rounded as the plain version (models/subframe.py lpc_candidates_plain)
rounds it, so the two agree bit for bit.

Bound: a -5 batch of 64 stereo frames is 256 problems of order 8 (~20 KB
of autocorrelations in, ~40 KB out): the card moves that in ~0.02 us at
3.35 TB/s (the NVIDIA H100 SXM data sheet's rate).  A launch is the serial
chain of one thread's dependent float64 operations (`chain_ops`) and the
launch itself.  chip_smoke.py measures it, with the chain's floor from
`chain_probe`.

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
        lib.flac_lpc_chain_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p]
        lib.flac_lpc_chain_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


def candidates(A: int, O: int, cfg) -> int:
    """AC, the LPC candidates a (frame, channel candidate): A apodizations,
    times O orders with -e, times the precisions with -p."""
    AC = A * (O if cfg.do_exhaustive_model_search else 1)
    return AC * (N_PREC if cfg.do_qlp_coeff_prec_search else 1)


def chain_ops(O: int, cfg) -> int:
    """Dependent float64 operations on one thread's critical path: the
    recursion (its inner sum, the reflection's add and divide, the error
    update), once for the errors and once more up to the guessed order
    (counted at O) without -e; then, per candidate, the quantizer's 32
    steps of error feedback (add, abs and add, floor, multiply, two
    clamps, the subtraction) and the order guess or estimate."""
    recursion = sum(i + 5 for i in range(O))
    per_candidate = 32 * 7 + 10
    if cfg.do_exhaustive_model_search:
        return recursion + candidates(1, O, cfg) * per_candidate
    return 2 * recursion + 3 * O + candidates(1, O, cfg) * per_candidate


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


def chain_probe(steps: int = 4096) -> float:
    """Clock cycles of one dependent float64 add on the card (one thread,
    `steps` of them in a row, clock64 around them)."""
    sink = torch.empty(1, dtype=torch.float64, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    kernels.check(_library().flac_lpc_chain_probe(
        steps, sink.data_ptr(), cycles.data_ptr()), "flac_lpc_chain_probe")
    return int(cycles.item()) / steps


def count_replay(n: int) -> None:
    """A CUDA graph that holds `n` K6 launches was replayed: they ran."""
    global launches
    launches += n
