"""Sparse NetES mixing (paper Eq. 3 over a padded neighbor list): the
wrapper of ``csrc/netes_sparse_mixing.cu``.

    out_j = Σ_k m_jk R̃θ_{i_jk} (θ_{i_jk} − θ_j) + σ Σ_k m_jk R̃ε_{i_jk} ε_{i_jk}

Replaces the TPU kernel
``repro/kernels/netes_sparse_mixing.py::netes_sparse_mixing``. On CUDA
tensors it launches the hand-written sm_90a kernel (the factored sum
Σ_k m_jk·Y[i_jk] − wsum_j·θ_j, Y = R̃θ·θ + σR̃ε·ε: the live slots compacted
into lists, then gathered from a slab of 32 columns of Y held in shared
memory; see the source's note); on CPU tensors it runs the plain version
``ref.sparse_mixing_ref``. On fake and meta tensors (a dry run's trace) it
returns empty results of the kernel's shapes and reports its costs
(``_checks.report``), launching nothing. There is no other path.

``netes_sparse_mixing_rs`` is the receiver ≠ sender instance of the
sharded fleet (``distributed.fleet_shard``): R receivers, S senders of a
payload, the slots in order with each product rounded (``csrc/_rows.cuh``),
equal to the plain version ``ref.sparse_mixing_rs_ref`` bit for bit.

The launch plan (slab width, sender chunks, grid) is made here by
:func:`plan` (``kernels/_slab.py``) from the library's occupancy query;
:func:`block_work` is the per-block work the kernel computes. The wrapper
allocates the lists' scratch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _slab, ref
from ._build import CudaKernel
from ._checks import (RS_MAX_COLUMNS, SLAB_MAX_COLUMNS, check_columns,
                      check_operand, on_cpu, report, shape_only)

KERNEL = CudaKernel(
    "netes_sparse_mixing", "netes_sparse_mixing_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 6
    + [ctypes.c_void_p])
OCCUPANCY = "netes_sparse_mixing_occupancy"
# The receiver ≠ sender instance (``netes_sparse_mixing_rs``, csrc/_rows.cuh)
KERNEL_RS = CudaKernel(
    "netes_sparse_mixing", "netes_sparse_mixing_rs_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

SLAB = 32            # float32 columns of Y per slab: 128 bytes a sender

block_work = _slab.block_work
chunk_bounds = _slab.chunk_bounds


def plan(n: int, p: int, sms: int, resident: int) -> _slab.SlabPlan:
    """The plan at (N, P) on a card of ``sms`` SMs holding ``resident``
    blocks each."""
    return _slab.make_plan(n, p, SLAB, sms, resident)


def launch_plan(n: int, p: int, device) -> _slab.SlabPlan:
    """The plan the wrapper launches at (N, P) on CUDA ``device``."""
    return _slab.launch_plan(KERNEL, OCCUPANCY, n, p, SLAB, device)


def occupancy(n: int, device) -> dict:
    """Resident blocks per SM, SMs, registers and local bytes per thread
    of the kernel at N senders (the library's queries)."""
    return _slab.device_occupancy(KERNEL, OCCUPANCY, n, device)


def netes_sparse_mixing(neighbor_idx: torch.Tensor,
                        neighbor_mask: torch.Tensor, w_theta: torch.Tensor,
                        w_eps: torch.Tensor, theta: torch.Tensor,
                        eps: torch.Tensor, *, sigma: float) -> torch.Tensor:
    """Eq. 3 over a padded neighbor list, before the α/(Nσ²) scale.

    neighbor_idx (N, K_max) int32 with entries in [0, N); neighbor_mask
    (N, K_max) float32 edge weights (0 on padding); w_theta, w_eps (N,);
    theta, eps (N, P); float32 and contiguous on one device, P at most
    ``_checks.SLAB_MAX_COLUMNS``. Returns (N, P) float32.
    """
    check_columns("theta", theta, SLAB_MAX_COLUMNS)
    operands = (neighbor_idx, neighbor_mask, w_theta, w_eps, theta, eps)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.sparse_mixing_ref(*operands, sigma=sigma)
    n, p = theta.shape
    k_max = neighbor_idx.shape[1] if neighbor_idx.dim() == 2 else -1
    check_operand("neighbor_idx", neighbor_idx, torch.int32, (n, k_max))
    for name, t, shape in (("neighbor_mask", neighbor_mask, (n, k_max)),
                           ("w_theta", w_theta, (n,)), ("w_eps", w_eps, (n,)),
                           ("theta", theta, (n, p)), ("eps", eps, (n, p))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    if k_max == 0:
        return out.zero_()
    # the plain version gathers and accumulates slot by slot: no dot FLOPs
    report("netes_sparse_mixing", 0.0, operands + (out,))
    if fake:
        return out
    pl = launch_plan(n, p, theta.device)
    # phase 1's slot lists (int32 pairs), their lengths, and wsum per
    # (receiver, chunk)
    scratch = torch.empty(2 * pl.list_entries(k_max) + 2 * n * pl.chunks,
                          dtype=torch.int32, device=theta.device)
    KERNEL.launch(neighbor_idx.data_ptr(), neighbor_mask.data_ptr(),
                  w_theta.data_ptr(), w_eps.data_ptr(), theta.data_ptr(),
                  eps.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  float(sigma), n, k_max, p, pl.chunk_rows, pl.chunks,
                  pl.grid, torch.cuda.current_stream(theta.device).cuda_stream)
    return out


def netes_sparse_mixing_rs(neighbor_idx: torch.Tensor,
                           neighbor_mask: torch.Tensor, w: torch.Tensor,
                           x: torch.Tensor,
                           theta: torch.Tensor) -> torch.Tensor:
    """Eq. 3 of R receivers over S senders from a padded list, before the
    α/(Nσ²) scale:

        out_j = Σ_k m_jk·w_i·x_i − (Σ_k m_jk·w_i)·θ_j,   i = idx[j, k],

    over the slots in order, each product rounded before its add (so a
    row's bits depend on its own slots alone).

    neighbor_idx (R, K) int32 with entries in [0, S); neighbor_mask (R, K)
    float32 (0 on padding); w (S,) the senders' weights; x (S, P) their
    payload; theta (R, P) the receivers' own θ; float32 and contiguous on
    one device, at most ``rows.TILE``·65535 columns. Returns (R, P).
    """
    check_columns("x", x, RS_MAX_COLUMNS)
    operands = (neighbor_idx, neighbor_mask, w, x, theta)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.sparse_mixing_rs_ref(*operands)
    r, p = theta.shape
    s = x.shape[0]
    k_max = neighbor_idx.shape[1] if neighbor_idx.dim() == 2 else -1
    check_operand("neighbor_idx", neighbor_idx, torch.int32, (r, k_max))
    for name, t, shape in (("neighbor_mask", neighbor_mask, (r, k_max)),
                           ("w", w, (s,)), ("x", x, (s, p)),
                           ("theta", theta, (r, p))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    if k_max == 0 or s == 0:
        return out.zero_()
    report("netes_sparse_mixing_rs", 0.0, operands + (out,))
    if fake:
        return out
    KERNEL_RS.launch(neighbor_idx.data_ptr(), neighbor_mask.data_ptr(),
                     w.data_ptr(), x.data_ptr(), theta.data_ptr(),
                     out.data_ptr(), r, s, k_max, p,
                     torch.cuda.current_stream(theta.device).cuda_stream)
    return out
