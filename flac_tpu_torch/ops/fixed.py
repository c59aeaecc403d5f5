"""Fixed polynomial predictors (orders 0-4), batched over subframes.

Port of the encode half of flac_tpu/ops/fixed.py (the reference's
src/libFLAC/fixed.c:470-566).  The residual of order o is the o-th finite
difference of the signal:

    e0[n] = x[n]
    e1[n] = x[n] -  x[n-1]
    e2[n] = x[n] - 2x[n-1] +  x[n-2]
    e3[n] = x[n] - 3x[n-1] + 3x[n-2] -  x[n-3]
    e4[n] = x[n] - 4x[n-1] + 6x[n-2] - 4x[n-3] + x[n-4]
"""

from __future__ import annotations

import torch

# Binomial predictor taps per order: residual[n] = sum_j COEF[o][j] * x[n-j]
_DIFF_COEFS = (
    (1,),
    (1, -1),
    (1, -2, 1),
    (1, -3, 3, -1),
    (1, -4, 6, -4, 1),
)


def _shift_right(x, j):
    """x delayed by j samples along the last axis (zeros shifted in)."""
    if j == 0:
        return x
    if j >= x.shape[-1]:
        return torch.zeros_like(x)
    return torch.nn.functional.pad(x[..., :-j], (j, 0))


def fixed_residuals_all(x):
    """Residuals for all five fixed orders in one pass.

    x: [..., N] integer (or exact float64) signal.
    Returns [..., 5, N] with residual order o at index o; entries at
    positions n < o are partial differences that the caller masks (warmup
    positions, never Rice-coded).  dtype follows x.
    """
    outs = []
    for coefs in _DIFF_COEFS:
        acc = None
        for j, c in enumerate(coefs):
            term = _shift_right(x, j) * c
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=-2)
