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


# The largest column count the slab kernels' 32-bit column arithmetic
# addresses (``csrc/_slab.cuh``: ``cols + SLAB − 1`` and a lane's last
# column ``col0 + 63`` stay below 2³¹).
SLAB_MAX_COLUMNS = 2**31 - 1 - 64


# The columns the receiver ≠ sender instances of the sparse pair address
# (``csrc/_rows.cuh``: a y-block of 1024 columns, at most 65535 of them).
RS_MAX_COLUMNS = 65535 * 1024


def check_columns(name: str, t: torch.Tensor, limit: int) -> None:
    """Raise ``ValueError`` if the last axis of ``t`` is longer than
    ``limit``, the columns a kernel's index arithmetic can address. Reads
    the shape only, so it holds for stride-only and meta tensors, and it
    runs before the device dispatch: the plain version's domain is the
    kernel's."""
    cols = t.shape[-1] if t.dim() else 1
    if cols > limit:
        raise ValueError(
            f"{name}: {cols} columns, more than the {limit} the kernel's "
            "32-bit column index addresses; mix it in column slabs")
