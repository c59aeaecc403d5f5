"""Exact integer helpers that torch lacks: OR/XOR reductions, bit length,
and a logical right shift for uint64 bit patterns held in int64.

Unsigned 32-bit values are carried in int64 in [0, 2^32); payloads of up to
63 bits (and uint64 bit patterns in general) in int64 with wrapping
arithmetic.  torch's `<<` on int64 is an unsigned shift that gives 0 at or
above the width, and `>>` is arithmetic, hence `srl64`.
"""

from __future__ import annotations

import torch


def fold_reduce(x: torch.Tensor, op, dim: int = -1) -> torch.Tensor:
    """Reduce `x` along `dim` with an associative bitwise op (torch has no
    OR/XOR reduction): pairwise tree fold, zero-padded to even length.
    Zero is the identity of both | and ^."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = op(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def or_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return fold_reduce(x, torch.bitwise_or, dim)


def xor_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return fold_reduce(x, torch.bitwise_xor, dim)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length (0 for 0) of non-negative values below 2^32, as
    int32: a five-step binary search (torch has no popcount or clz)."""
    v = x.to(torch.int64)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        n = n + big * s
        v = torch.where(big, v >> s, v)
    return (n + (v > 0)).to(torch.int32)


def srl64(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of uint64 bit patterns held in int64, for shift
    amounts in [0, 63]."""
    return (x >> s) & ~(torch.full_like(x, -1) << (64 - s))
