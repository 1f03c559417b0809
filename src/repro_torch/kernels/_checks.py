"""Argument checks and cost reports shared by the kernel wrappers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..obs import cuda_watch


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


def shape_only(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """True if an operand is a ``FakeTensor`` or lies on the meta device:
    the wrapper then returns empty results of the shapes its kernel
    gives, reports the kernel's costs and launches nothing (a dry run's
    trace, ``launch.op_costs``). A real tensor, on the CPU or the card,
    never takes this path."""
    from torch._subclasses.fake_tensor import is_fake
    tensors = [t for t in tensors if t is not None]
    if not any(t.device.type == "meta" or is_fake(t) for t in tensors):
        return False
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return True


def report(name: str, flops: float,
           tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """One kernel call's costs to ``obs.cuda_watch``: ``flops`` the dot
    FLOPs its plain version does, and the bytes of ``tensors`` (its
    operands read once and its results written once)."""
    cuda_watch.report_kernel(name, flops, sum(
        t.numel() * t.element_size() for t in tensors if t is not None))


def has_dtensor(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """True if an operand is a DTensor (a dry run over a mesh): the
    wrapper then runs on each device's shards
    (``distributed.context.on_shards``), where it sees plain tensors."""
    return any(type(t).__name__ == "DTensor" for t in tensors
               if t is not None)


def on_shards(fn, args, dims, out_dims):
    from ..distributed.context import on_shards as run
    return run(fn, args, dims, out_dims)
