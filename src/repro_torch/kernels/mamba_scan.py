"""Mamba selective-scan recurrence: the wrapper of ``csrc/mamba_scan.cu``.

    h_t = decay_t ⊙ h_{t−1} + drive_t        (per channel d, state n)

Replaces the TPU kernel ``repro/kernels/mamba_scan.py::mamba_scan``, with
its layout, and takes an initial state ``h0`` besides (the TPU kernel
starts from zero): a decode step is the recurrence at S = 1 from the
cached state. On CUDA tensors it launches the hand-written sm_90a kernel
(see the source's note); on CPU tensors it runs the plain version
``ref.mamba_scan_ref``. On fake and meta tensors (a dry run's trace) it
returns empty results of the kernel's shapes and reports its costs
(``_checks.report``), launching nothing. There is no other path. Float32 only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from ._build import CudaKernel
from ._checks import (check_operand, has_dtensor, on_cpu, on_shards, report,
                      shape_only)

KERNEL = CudaKernel("mamba_scan", "mamba_scan_f32",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])

MAX_BATCH = 65535     # the kernel's grid takes the batch on its y axis


def mamba_scan(decay: torch.Tensor, drive: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """decay, drive (B, S, D, N) float32; h0 (B, D, N) float32 or None (a
    zero state). Returns every h_t, (B, S, D, N) float32. DTensor
    operands run on each device's batch rows and channels."""
    if has_dtensor((decay, drive, h0)):
        return on_shards(mamba_scan, (decay, drive, h0),
                         ((0, 2), (0, 2), (0, 1)), (0, 2))
    if decay.dim() != 4:
        raise ValueError(f"decay: shape {tuple(decay.shape)}, expected "
                         "(B, S, D, N)")
    b, s, d, n = decay.shape
    if s < 1 or b > MAX_BATCH:
        raise ValueError(f"B = {b}, S = {s}: the kernel takes S ≥ 1 and "
                         f"B ≤ {MAX_BATCH}")
    operands = [("decay", decay, (b, s, d, n)), ("drive", drive, (b, s, d, n))]
    if h0 is not None:
        operands.append(("h0", h0, (b, d, n)))
    for name, t, shape in operands:
        check_operand(name, t, torch.float32, shape)
    fake = shape_only([t for _, t, _ in operands])
    if not fake and on_cpu([t for _, t, _ in operands]):
        return ref.mamba_scan_ref(decay, drive, h0)
    h = torch.empty_like(decay)
    if b * d * n == 0:
        return h
    # the plain version is elementwise: no dot FLOPs
    report("mamba_scan", 0.0, (decay, drive, h0, h))
    if fake:
        return h
    KERNEL.launch(decay.data_ptr(), drive.data_ptr(),
                  None if h0 is None else h0.data_ptr(), h.data_ptr(),
                  b, s, d, n,
                  torch.cuda.current_stream(decay.device).cuda_stream)
    return h
