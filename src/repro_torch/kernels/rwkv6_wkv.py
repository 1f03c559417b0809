"""RWKV-6 WKV recurrence with a data-dependent decay: the wrapper of
``csrc/rwkv6_wkv.cu``.

    out_t = r_t · (diag(u) · k_tᵀ v_t + S_{t−1})
    S_t   = diag(w_t) · S_{t−1} + k_tᵀ v_t

Replaces the TPU kernel ``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``, with
its signature and layout, and takes an initial state ``s0`` besides (the
TPU kernel starts from zero): prefill continues a cache, and a decode step
is the recurrence at S = 1. On CUDA tensors it launches the hand-written
sm_90a kernel (see the source's note); on CPU tensors it runs the plain
version ``ref.rwkv6_wkv_ref``. There is no other path. Float32 only, head
width n ≤ 64 (64 for every registry config; the reference's tests use 8,
16 and 32).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from ._build import CudaKernel
from ._checks import check_operand, on_cpu

KERNEL = CudaKernel("rwkv6_wkv", "rwkv6_wkv_f32",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])

MAX_HEAD_DIM = 64     # what the kernel is built for


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None):
    """r, k, v, w (B, S, H, n) float32, w the decay in (0, 1); u (H, n)
    float32; s0 (B, H, n, n) float32 or None (a zero state). Returns
    (out (B, S, H, n) float32, final state (B, H, n, n) float32)."""
    if r.dim() != 4:
        raise ValueError(f"r: shape {tuple(r.shape)}, expected (B, S, H, n)")
    b, s, h, n = r.shape
    if s < 1 or not 1 <= n <= MAX_HEAD_DIM:
        raise ValueError(f"S = {s}, n = {n}: the kernel takes S ≥ 1 and "
                         f"1 ≤ n ≤ {MAX_HEAD_DIM}")
    operands = [("r", r, (b, s, h, n)), ("k", k, (b, s, h, n)),
                ("v", v, (b, s, h, n)), ("w", w, (b, s, h, n)),
                ("u", u, (h, n))]
    if s0 is not None:
        operands.append(("s0", s0, (b, h, n, n)))
    for name, t, shape in operands:
        check_operand(name, t, torch.float32, shape)
    if on_cpu([t for _, t, _ in operands]):
        return ref.rwkv6_wkv_ref(r, k, v, w, u, s0)
    out = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, s_fin
    KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), None if s0 is None else s0.data_ptr(),
                  out.data_ptr(), s_fin.data_ptr(), b, s, h, n,
                  torch.cuda.current_stream(r.device).cuda_stream)
    return out, s_fin
