"""Partitioned Rice coding: exact parameter + partition-order search.

Port of flac_tpu/ops/rice.py.  Exact code lengths for every
(partition order, partition, parameter) triple in one batched pass:

    bits(p, k) = n_p * (k + 1) + sum_{i in p} (fold(r_i) >> k)

(cf. the EXACT_RICE_BITS_CALCULATION variant, stream_encoder.c:4913-4927).

Folded values u < 2^32 are carried in int64, so every shifted partition sum
is exact in int64 (< N * 2^32 <= 2^47) and exact again in float64, where the
k-cost combination happens — the same integers the reference computes from
its int32 half sums, hence the same costs and the same argmins.
"""

from __future__ import annotations

import torch

from .bitops import bit_length, or_reduce

# Sentinel cost for invalid configurations.  Far above any real frame
# (max ~2^21 bits) and far below int32 overflow even when two sentinels
# are summed across channels.
BIG = 1 << 28

# best_k entries >= ESCAPE_K_BASE mark an escaped partition; the raw bit
# width is (entry - ESCAPE_K_BASE)
ESCAPE_K_BASE = 64


def zigzag(residual: torch.Tensor) -> torch.Tensor:
    """Fold a signed int32 residual to unsigned: u = (r<<1) ^ (r>>31)
    (bitwriter.c:616-625), returned as int64 in [0, 2^32)."""
    if residual.dtype != torch.int32:
        raise TypeError(f"zigzag takes int32 residuals, got {residual.dtype}")
    folded = (residual << 1) ^ (residual >> 31)
    return folded.to(torch.int64) & 0xFFFFFFFF


def partition_cost_table(u, order, N: int, max_po: int, kmax: int,
                         plen: int = 4, escape: bool = False):
    """Exact Rice cost over all partition orders and parameters.

    u:      [..., N] int64 zigzag-folded residual in [0, 2^32); positions
            < order MUST be zero (warmup positions, excluded from coding).
    order:  [...] int32 predictor order.
    max_po: highest partition order to consider.
    kmax:   highest Rice parameter (14 for RICE, 30 for RICE2).
    plen:   parameter field width (4 RICE / 5 RICE2).

    Returns:
      best_bits [..., max_po+1] int32 — total residual-coding bits at each
          partition order (per-partition best cost incl. parameter-field
          bits), or BIG if invalid; excludes the 2-bit method + 4-bit
          order fields.
      best_k    [..., max_po+1, 2^max_po] int32 — best parameter per
          partition at each order (entries beyond 2^po unused).
    """
    assert N <= (1 << 15), "blocksize cap of the reference's half sums"
    P = 1 << max_po
    m = N >> max_po                        # finest partition length
    batch = tuple(u.shape[:-1])
    K = kmax + 1
    dev = u.device

    ug = u.reshape(batch + (P, m))
    # finest-level exact shifted sums, one plane per parameter
    sums = torch.stack([(ug >> k).sum(-1) for k in range(K)], dim=-1)
    if escape:
        # raw width for an escaped partition: zigzag u < 2^n iff the
        # residual fits n-bit signed raw, so width = bit_length(max u)
        # = bit_length(OR over the partition); OR pair-merges up the tree
        orv = or_reduce(ug)

    order_f = order.to(torch.float64)
    ks = torch.arange(K, dtype=torch.float64, device=dev)
    levels_bits, levels_k = [], []

    for po in range(max_po, -1, -1):
        parts = 1 << po
        n_eff = torch.full(batch + (parts,), float(N >> po),
                           dtype=torch.float64, device=dev)
        # partition 0 excludes the predictor warmup samples
        n_eff[..., 0] -= order_f
        cost = n_eff[..., None] * (ks + 1) + sums.to(torch.float64) + plen
        best = torch.clamp(cost.min(dim=-1).values, max=float(BIG))
        bk = cost.argmin(dim=-1).to(torch.int32)
        if escape:
            # escaped partition: plen-bit all-ones marker + 5-bit width +
            # n raw bits each (stream_encoder.c:4854-4910 precompute +
            # writer; decoder at stream_decoder.c:3338-3352)
            rawb = bit_length(orv)
            esc_cost = n_eff * rawb.to(torch.float64) + plen + 5
            use_esc = esc_cost < best
            best = torch.minimum(best, esc_cost)
            bk = torch.where(use_esc, ESCAPE_K_BASE + rawb, bk)
        total = best.sum(dim=-1)
        # validity: partition 0 must retain samples after warmup exclusion
        # (format.c:541-553 / set_partitioned_rice_ semantics)
        valid = n_eff[..., 0] > 0
        total32 = torch.where(valid, torch.clamp(total, max=float(BIG)),
                              float(BIG)).to(torch.int32)
        levels_bits.append(total32)
        levels_k.append(torch.nn.functional.pad(bk, (0, P - parts)))
        if po > 0:
            # pair-merge the sums for the next (coarser) level
            sums = sums.reshape(batch + (parts // 2, 2, K)).sum(-2)
            if escape:
                orv = orv.reshape(batch + (parts // 2, 2))
                orv = orv[..., 0] | orv[..., 1]

    best_bits = torch.stack(levels_bits[::-1], dim=-1)   # [..., max_po+1]
    best_k = torch.stack(levels_k[::-1], dim=-2)         # [..., max_po+1, P]
    return best_bits, best_k
