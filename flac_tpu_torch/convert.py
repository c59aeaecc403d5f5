"""Carry the encoder's state across from the JAX reference, as plain data.

A codec has no weights, but three things must enter flac_tpu and
flac_tpu_torch identically for the two to be compared: the configuration,
the apodization bank and the per-subframe choices.  These helpers take
them as plain Python/numpy values (never flac_tpu objects) and build the
port's own types with the port's dtypes: unsigned 32-bit values widen to
int64, uint64 bit patterns are reinterpreted as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EncoderConfig
from .models.frame import PackedFrames
from .models.subframe import SubframeChoice
from .ops.lpc import ApodizationBank


def config_from_reference(d: dict) -> EncoderConfig:
    """EncoderConfig from `dataclasses.asdict` of a reference config."""
    d = dict(d)
    d["apodizations"] = tuple(d["apodizations"])
    return EncoderConfig(**d)


def bank_from_reference(windows, combine, names) -> ApodizationBank:
    """ApodizationBank from the reference bank's numpy arrays."""
    return ApodizationBank(windows=np.asarray(windows, np.float32),
                           combine=np.asarray(combine, np.float32),
                           names=tuple(names))


def tensor_from_reference(a, device="cpu") -> torch.Tensor:
    """One numpy array -> torch tensor with the port's dtype."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def choice_from_reference(device="cpu", **arrays):
    """Numpy arrays of a reference SubframeChoice or PackedFrames (by field
    name) -> the port's SubframeChoice or PackedFrames on `device`."""
    tensors = {k: tensor_from_reference(v, device) for k, v in arrays.items()}
    for cls in (SubframeChoice, PackedFrames):
        if set(tensors) == set(cls._fields):
            return cls(**tensors)
    raise ValueError(f"fields {sorted(tensors)} match neither SubframeChoice "
                     "nor PackedFrames")
