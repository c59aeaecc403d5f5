"""Kernel K1: the quad-layout bit-pack deposit as a hand-written CUDA kernel.

Replaces flac_tpu/ops/pack_pallas.py:_kernel (a bf16 one-hot matmul per
byte plane on the TPU's matrix unit).  The source is
csrc/pack_fields64.cu, designed for Hopper: a thread block cluster of
CLUSTER CTAs per frame.  Each CTA loads its share of the frame's fields
into registers in one batch and scans it once; the CTAs exchange their
shares' bit totals through distributed shared memory; the frame's word
words that can hold bits (`used_words`) are split among the cluster's
shared memories (`rank_words` words a CTA), the rest of the row is stored
as zeros before the deposit, and each field's three word contributions
are OR'ed into the tile of the CTA that owns the word, local or remote;
each CTA stores its words with 16-byte stores (see the source for the
design).

Bound: per -5 batch (B=64 frames, S=2263 fields, W=8192 words) the deposit
must read 64*2263*16 B ~ 2.3 MB and write 64*8192*4 B ~ 2.1 MB of uint32
words: ~1.3 us of HBM time at 3.35 TB/s, with about 16 integer operations
per field.  (The kernel stores each word zero-extended in int64, the port's
word type, which doubles its own writes; the bound counts the function's.)
It is bound by bytes on paper and by a few dependent memory latencies and
cluster barriers in practice; chip_smoke.py measures it.

Unlike the TPU kernel it has no word-capacity cap: it fills all
`max_words`, so its result is exactly that of the plain version,
`bitpack.pack_fields64`.

`pack_fields64` dispatches on the tensors' device: the plain version for
CPU tensors, the kernel for CUDA tensors (it launches or raises; there is
no fallback).  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import bitpack

SOURCE = "flac_tpu_torch/csrc/pack_fields64.cu"
REPLACES = "flac_tpu/ops/pack_pallas.py:88"     # _kernel
_LIB_NAME = "pack_fields64"
CLUSTER = 2                  # CTAs a frame (CLUSTER in the source)
TILE_WORDS_MAX = 16384       # words a CTA's tile holds

launches = 0          # kernel launches of pack_fields64_cuda in this process
_lib = None
_probed: set = set()  # devices on which P1 passed


def used_words(nzeros, pbits, W: int) -> int:
    """The words of one frame's [W] row that can hold bits, as the kernel
    reckons them: ceil(total bits / 32), at most W, when no nzeros is
    negative and the int32 total stays below 2^31 (positions then only
    grow); else all W.  The kernel stores the rest as zeros first."""
    nz = np.asarray(nzeros, np.int64)
    total = int((nz + np.asarray(pbits, np.int64)).sum()) & 0xFFFFFFFF
    if (nz < 0).any() or total >= 1 << 31:
        return W
    return min(W, (total + 31) >> 5)


def rank_words(W: int, used: int | None = None) -> int:
    """Words of a pass over a frame's `used` words (used_words; W if None)
    that each CTA of the cluster owns: rank r owns [r * n, (r + 1) * n) of
    the pass, n a multiple of 4 words, at most TILE_WORDS_MAX and at most
    the launch's tile of ceil(W / CLUSTER) words.  More than CLUSTER * n
    used words take several passes."""
    used = W if used is None else used
    tile = min(TILE_WORDS_MAX, (-(-W // CLUSTER) + 3) & ~3)
    return min(tile, (-(-used // CLUSTER) + 3) & ~3)


def _bound_library() -> ctypes.CDLL:
    """Build/load the library once and declare its C signatures."""
    global _lib
    if _lib is None:
        lib, _ = kernels.load(_LIB_NAME)
        lib.flac_pack_fields64.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.flac_pack_fields64.restype = ctypes.c_int
        lib.flac_probe_x2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.flac_probe_x2.restype = ctypes.c_int
        _lib = lib
    return _lib


def _library() -> ctypes.CDLL:
    """The bound library, with P1 run once on the current device."""
    lib = _bound_library()
    dev = torch.cuda.current_device()
    if dev not in _probed:
        probe()
        _probed.add(dev)
    return lib


def probe() -> None:
    """P1 (replaces flac_tpu/ops/pack_pallas.py:available's probe kernel):
    x2 over an (8, 128) int32 tile on the current GPU.  Raises unless the
    kernel ran and doubled every value."""
    lib = _bound_library()
    x = torch.arange(8 * 128, dtype=torch.int32, device="cuda").reshape(8, 128)
    y = torch.empty_like(x)
    kernels.check(lib.flac_probe_x2(
        x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream), "flac_probe_x2 launch")
    torch.cuda.synchronize()
    if not torch.equal(y, x * 2):
        raise RuntimeError("flac_probe_x2: the probe kernel returned wrong "
                           "values on this GPU")


def pack_fields64_cuda(nzeros, payload64, pbits, max_words: int):
    """Launch K1.  nzeros/pbits [B, S] int32, payload64 [B, S] int64 (uint64
    bit patterns), all on one CUDA device.  Returns (words [B, max_words]
    int64 holding uint32, total_bits [B] int32), as the plain version."""
    global launches
    for name, t in (("nzeros", nzeros), ("payload64", payload64),
                    ("pbits", pbits)):
        if t.device.type != "cuda":
            raise ValueError(f"pack_fields64_cuda: {name} is not on a GPU")
        if t.ndim != 2 or t.shape != nzeros.shape:
            raise ValueError(f"pack_fields64_cuda: {name} has shape "
                             f"{tuple(t.shape)}, want {tuple(nzeros.shape)}")
    B, S = nzeros.shape
    if B == 0:
        return (torch.zeros((0, max_words), dtype=torch.int64,
                            device=nzeros.device),
                torch.zeros((0,), dtype=torch.int32, device=nzeros.device))
    nz = nzeros.to(torch.int32).contiguous()
    pay = payload64.to(torch.int64).contiguous()
    pb = pbits.to(torch.int32).contiguous()
    words = torch.empty((B, max_words), dtype=torch.int64, device=nz.device)
    total = torch.empty((B,), dtype=torch.int32, device=nz.device)
    with torch.cuda.device(nz.device):
        lib = _library()
        kernels.check(lib.flac_pack_fields64(
            nz.data_ptr(), pay.data_ptr(), pb.data_ptr(), words.data_ptr(),
            total.data_ptr(), B, S, max_words,
            torch.cuda.current_stream().cuda_stream),
            "flac_pack_fields64 launch")
    launches += 1
    return words, total


def pack_fields64(nzeros, payload64, pbits, max_words: int):
    """K1's wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if nzeros.device.type == "cpu":
        return bitpack.pack_fields64(nzeros, payload64, pbits, max_words)
    if nzeros.device.type == "cuda":
        return pack_fields64_cuda(nzeros, payload64, pbits, max_words)
    raise ValueError(f"pack_fields64: unsupported device {nzeros.device}")
