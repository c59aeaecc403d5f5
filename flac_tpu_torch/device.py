"""Device selection for the entry points (the GPU unless asked otherwise),
and the per-device cache of constants built from host data."""

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


# (key, device) -> tensor
_CONSTANTS: dict = {}


def constant(key, device: torch.device, make) -> torch.Tensor:
    """The tensor `make(device)` builds from host data (a table, a window
    bank), built once for each (key, device) and kept for the process.

    The encode path takes its constants from here, so a warm call copies
    nothing from host memory: a per-call copy of a host list or array is a
    pageable host-to-device transfer, and one that a CUDA graph capture
    refuses.  `key` must name the contents (hashable; include every
    parameter the table depends on).  Callers must not modify the tensor.
    """
    dev = torch.device(device)
    t = _CONSTANTS.get((key, dev))
    if t is None:
        t = _CONSTANTS[(key, dev)] = make(dev)
    return t
