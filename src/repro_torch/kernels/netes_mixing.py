"""Dense NetES mixing (paper Eq. 3): the wrapper of ``csrc/netes_mixing.cu``.

    out_j = Σ_i a_ji R̃θ_i (θ_i − θ_j) + σ Σ_i a_ji R̃ε_i ε_i

Replaces the TPU kernel ``repro/kernels/netes_mixing.py::netes_mixing``. On
CUDA tensors it launches the hand-written sm_90a kernel (a tiled f32 GEMM
over the stacked source axis, see the source's note); on CPU tensors it
runs the plain version ``ref.netes_mixing_ref``. There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import CudaKernel
from ._checks import check_operand, on_cpu

KERNEL = CudaKernel(
    "netes_mixing", "netes_mixing_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])


def netes_mixing(adj: torch.Tensor, w_theta: torch.Tensor,
                 w_eps: torch.Tensor, theta: torch.Tensor, eps: torch.Tensor,
                 *, sigma: float) -> torch.Tensor:
    """Eq. 3 over a dense adjacency, before the α/(Nσ²) scale.

    adj (N, N); w_theta, w_eps (N,); theta, eps (N, P); all float32 and
    contiguous on one device. Returns (N, P) float32.
    """
    operands = (adj, w_theta, w_eps, theta, eps)
    if on_cpu(operands):
        return ref.netes_mixing_ref(*operands, sigma=sigma)
    n, p = theta.shape
    for name, t, shape in (("adj", adj, (n, n)), ("w_theta", w_theta, (n,)),
                           ("w_eps", w_eps, (n,)), ("theta", theta, (n, p)),
                           ("eps", eps, (n, p))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    KERNEL.launch(adj.data_ptr(), w_theta.data_ptr(), w_eps.data_ptr(),
                  theta.data_ptr(), eps.data_ptr(), out.data_ptr(),
                  float(sigma), n, p,
                  torch.cuda.current_stream(theta.device).cuda_stream)
    return out
