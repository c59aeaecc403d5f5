"""Deterministic test signals, made from a numpy seed.

`make_test_signal` follows the recipe of tests/conftest.py:make_test_signal
(sum of sines + noise under a slow envelope, the shape FLAC compresses
well); `make_transient_signal` follows the transient section of bench.py's
corpus (gated square bursts with sparse full-scale clicks), content that
makes the quad layout flag frames for the safe re-encode;
`make_hires32_signal` follows the 32-bit recipe of tests/test_hires.py
(24-bit music shifted to 32 bits under low-bit noise), whose side channel
needs 33 bits.
"""

from __future__ import annotations

import numpy as np


def make_test_signal(n: int, channels: int = 2, bps: int = 16,
                     seed: int = 0, rate: float = 44100.0) -> np.ndarray:
    """[channels, n] int32 pseudo-musical signal at full scale `bps`."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    full = (1 << (bps - 1)) - 1
    out = np.zeros((channels, n))
    for c in range(channels):
        sig = np.zeros(n)
        for f, a in ((220 * (c + 1), 0.4), (440, 0.2), (1230.5, 0.1)):
            sig += a * np.sin(2 * np.pi * f * t + c)
        sig += 0.02 * rng.standard_normal(n)
        env = 0.1 + 0.9 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.3 * t))
        out[c] = sig * env
    out = np.clip(out * 0.5 * full, -full - 1, full)
    return np.round(out).astype(np.int32)


def make_transient_signal(n: int, channels: int = 2, seed: int = 0,
                          clicks_per_second: float = 70.0,
                          rate: float = 44100.0) -> np.ndarray:
    """[channels, n] int32 16-bit transients: square bursts at 311 Hz gated
    on and off three times a second, with full-scale single-sample
    clicks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    burst = np.sign(np.sin(2 * np.pi * 311 * t))
    gate = np.sin(2 * np.pi * 3.0 * t) > 0.7
    out = np.zeros((channels, n)) + 12000 * burst * gate
    k = max(1, int(clicks_per_second * n / rate))
    clicks = rng.integers(0, n, k)
    out[:, clicks] = rng.choice([-30000, 30000], (channels, k))
    return out.astype(np.int32)


def make_hires32_signal(n: int, seed: int = 9) -> np.ndarray:
    """[2, n] int32 32-bit stereo: 24-bit music << 8 plus noise in the low
    8 bits.  Its side channel L - R spans 33 bits."""
    rng = np.random.default_rng(seed)
    base = make_test_signal(n, bps=24).astype(np.int64) << 8
    return np.clip(base + rng.integers(-128, 128, base.shape),
                   -(1 << 31), (1 << 31) - 1).astype(np.int32)
