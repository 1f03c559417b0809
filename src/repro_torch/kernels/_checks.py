"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

from typing import Sequence

import torch


def on_cpu(tensors: Sequence[torch.Tensor]) -> bool:
    """True if every tensor lies on the CPU; False if every tensor lies on
    one CUDA device. Anything else raises: a wrapper never moves data."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: Sequence[int]) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` and a contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
