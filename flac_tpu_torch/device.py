"""Device selection for the entry points: the GPU unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda".  Asking for a GPU that is not there raises: an
    entry point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flac_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev
