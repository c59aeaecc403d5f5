"""Kernel K2: the Rice/raw code scan of the device decoder, hand-written CUDA.

Replaces flac_tpu/ops/bitunpack.py:_rice_kernel (a Pallas kernel that keeps
each block of lanes' gathered windows in VMEM and extracts words by one-hot
sums, because the TPU has no cheap per-lane gather).  The source is
csrc/rice_codes.cu: one thread per lane, the segment queue in registers,
words read straight from the uploaded stream (no materialised window), and
res[t, lane] stored each step, coalesced across a warp.  Narrow lanes give
int32 codes, wide lanes (33-bit side channels, raw widths above 32, Rice
values of 2^32 or more) int64, both on the kernel.

Bound: per full -5 batch (1024 frames of 4096 stereo samples: L = 65,536
lanes, T = 128) the function reads the compressed stream once (~10.3 MB),
segs (~2.1 MB) and lane_start (0.26 MB) and writes res (33.5 MB) and ovf:
~46 MB, ~14 us at 3.35 TB/s; its ~8.4 M codes at a few tens of integer
operations each stay under that, so bytes bound it.  chip_smoke.py reckons
the bound of the real batch it times.

`rice_codes` dispatches on the tensors' device: the plain version
(`bitunpack.rice_codes_plain`) for CPU tensors, the kernel for CUDA tensors
(it launches or raises; there is no fallback).  `launches` counts kernel
launches.  P2, `probe`, runs once per device after the build and raises
unless the card computes what the host does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import bitunpack

SOURCE = "flac_tpu_torch/csrc/rice_codes.cu"
REPLACES = "flac_tpu/ops/bitunpack.py:201"     # _rice_kernel
LIB_NAME = "rice_codes"
SEG_MAX = 8

launches = 0          # kernel launches of rice_codes_cuda in this process
_lib = None
_probed: set = set()  # devices on which P2 passed


def _bound_library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signatures."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(LIB_NAME)
        p = ctypes.c_void_p
        lib.flac_rice_codes.argtypes = [p, ctypes.c_longlong, p, p, p, p] + [
            ctypes.c_int] * 6 + [p]
        lib.flac_rice_codes.restype = ctypes.c_int
        lib.flac_probe_clz_shift.argtypes = [p, p, ctypes.c_int, p]
        lib.flac_probe_clz_shift.restype = ctypes.c_int
        _lib = lib
    return _lib


def _library() -> ctypes.CDLL:
    """The bound library, with P2 run once on the current device."""
    lib = _bound_library()
    dev = torch.cuda.current_device()
    if dev not in _probed:
        probe()
        _probed.add(dev)
    return lib


def probe_expected(v: np.ndarray) -> np.ndarray:
    """What P2 must return for uint32 values v: clz(v) + (v >> (v & 7))."""
    v = v.astype(np.uint64)
    clz = 32 - np.array([int(x).bit_length() for x in v], np.uint64)
    return (clz + (v >> (v & np.uint64(7)))).astype(np.uint32).view(np.int32)


def probe() -> None:
    """P2 (replaces the probe kernel of flac_tpu/ops/bitunpack.py:
    rice_pallas_available): clz plus a variable shift over an (8, 128)
    uint32 tile on the current GPU.  Raises unless every value is what the
    host computes; it never reroutes."""
    lib = _bound_library()
    v = np.arange(8 * 128, dtype=np.uint64) * np.uint64(2654435761)
    v = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    v[0] = 16                                    # the reference's 27 + 16
    x = torch.from_numpy(v.view(np.int32).reshape(8, 128)).cuda()
    y = torch.empty_like(x)
    kernels.check(lib.flac_probe_clz_shift(
        x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream), "flac_probe_clz_shift")
    torch.cuda.synchronize()
    want = probe_expected(v).reshape(8, 128)
    if int(y[0, 0]) != 27 + 16 or not np.array_equal(y.cpu().numpy(), want):
        raise RuntimeError("flac_probe_clz_shift: the probe kernel returned "
                           "wrong values on this GPU")


def rice_codes_cuda(words2d, lane_start, segs, *, T: int, NROW: int,
                    SEG: int, wide: bool):
    """Launch K2.  words2d [R, 16] (uint32 bits in int32, or uint32 values
    in int64), lane_start [L], segs [L, >= SEG], all on one CUDA device.
    Returns (res [T, L] int32, int64 when wide; ovf [L] bool), as the
    plain version."""
    global launches
    for name, t in (("words2d", words2d), ("lane_start", lane_start),
                    ("segs", segs)):
        if t.device.type != "cuda" or t.device != words2d.device:
            raise ValueError(f"rice_codes_cuda: {name} is not on the GPU of "
                             "words2d")
    L = lane_start.shape[0]
    if words2d.ndim != 2 or words2d.shape[1] != 16 or words2d.shape[0] < 1:
        raise ValueError(f"rice_codes_cuda: words2d has shape "
                         f"{tuple(words2d.shape)}, want [R >= 1, 16]")
    if lane_start.ndim != 1 or segs.ndim != 2 or segs.shape[0] != L \
            or segs.shape[1] < SEG:
        raise ValueError("rice_codes_cuda: want lane_start [L] and segs "
                         f"[L, >= {SEG}], got {tuple(lane_start.shape)} and "
                         f"{tuple(segs.shape)}")
    if not 1 <= SEG <= SEG_MAX or NROW < 1 or T < 0:
        raise ValueError(f"rice_codes_cuda: SEG={SEG} (1..{SEG_MAX}), "
                         f"NROW={NROW}, T={T}")
    dev = words2d.device
    words = words2d.to(torch.int32).contiguous()    # keeps the low 32 bits
    ls = lane_start.to(torch.int32).contiguous()
    sg = segs[:, :SEG].to(torch.int32).contiguous()
    res = torch.empty((T, L), dtype=torch.int64 if wide else torch.int32,
                      device=dev)
    ovf = torch.empty((L,), dtype=torch.bool, device=dev)
    if L == 0:
        return res, ovf
    with torch.cuda.device(dev):
        lib = _library()
        kernels.check(lib.flac_rice_codes(
            words.data_ptr(), words.shape[0], ls.data_ptr(), sg.data_ptr(),
            res.data_ptr(), ovf.data_ptr(), L, T, NROW, SEG, SEG, int(wide),
            torch.cuda.current_stream().cuda_stream), "flac_rice_codes launch")
    launches += 1
    return res, ovf


def rice_codes(words2d, lane_start, segs, *, T: int, NROW: int, SEG: int,
               wide: bool):
    """K2's wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if words2d.device.type == "cpu":
        return bitunpack.rice_codes_plain(words2d, lane_start, segs, T=T,
                                          NROW=NROW, SEG=SEG, wide=wide)
    if words2d.device.type == "cuda":
        return rice_codes_cuda(words2d, lane_start, segs, T=T, NROW=NROW,
                               SEG=SEG, wide=wide)
    raise ValueError(f"rice_codes: unsupported device {words2d.device}")
