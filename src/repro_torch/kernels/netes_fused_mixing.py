"""Fused decode∘mask∘neighbor-sum over quantized wire payloads, and the
fused broadcast select (DESIGN.md §12): the wrappers of
``csrc/netes_fused_mixing.cu``.

    fused_neighbor_sum:     out_j = Σ_k ws_jk · codes[i_jk],
                            ws_jk = ((m_jk · coeff[i_jk]) · em_jk) · scale[i_jk]
    fused_broadcast_select: out = where(flag, codes · scale, θ)

Replace the TPU kernels ``repro/kernels/netes_fused_mixing.py::
fused_neighbor_sum`` and ``::fused_broadcast_select``. The neighbor-sum
kernel folds the slot weights ``ws`` itself, in the reference's order
(bit for bit ``ref.folded_weights``), compacts the live slots into
lists, and gathers the codes from a slab of 64 columns held in shared
memory as bf16: one launch per call. On CUDA tensors each wrapper
launches its hand-written sm_90a kernel (see the source's note); on CPU
tensors it runs the plain version in ``kernels/ref.py``. On fake and
meta tensors (a dry run's trace) it returns empty results of the
kernel's shapes and reports its costs (``_checks.report``), launching
nothing. There is no other path.

``fused_neighbor_sum_rs`` is the receiver ≠ sender instance of the
sharded fleet (``distributed.fleet_shard``): R receivers over S senders'
codes, each slot's code decoded (code · scale) and weighted in slot order,
with Eq. 3's correction term, equal to ``ref.fused_neighbor_sum_rs_ref``
bit for bit.

The neighbor sum's launch plan (slab width, sender chunks, grid) is made
here by :func:`plan` (``kernels/_slab.py``) from the library's occupancy
query; :func:`block_work` is the per-block work the kernel computes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _slab, ref
from ._build import CudaKernel
from ._checks import (RS_MAX_COLUMNS, SLAB_MAX_COLUMNS, check_columns,
                      check_operand, on_cpu, report, shape_only)

NEIGHBOR_SUM = CudaKernel(
    "netes_fused_mixing", "fused_neighbor_sum_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
BROADCAST_SELECT = CudaKernel(
    "netes_fused_mixing", "fused_broadcast_select_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
OCCUPANCY = "fused_neighbor_sum_occupancy"
# The receiver ≠ sender instance (``fused_neighbor_sum_rs``, csrc/_rows.cuh)
NEIGHBOR_SUM_RS = CudaKernel(
    "netes_fused_mixing", "fused_neighbor_sum_rs_f32",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

SLAB = 64            # columns of codes per slab, held as bf16: 128 bytes
# The broadcast select's grid has a y-block per 512 columns, and a grid's
# y extent is at most 65535.
SELECT_TILE = 512
SELECT_MAX_COLUMNS = 65535 * SELECT_TILE

block_work = _slab.block_work
chunk_bounds = _slab.chunk_bounds


def plan(n: int, d: int, sms: int, resident: int) -> _slab.SlabPlan:
    """The neighbor sum's plan at (N, D) on a card of ``sms`` SMs holding
    ``resident`` blocks each."""
    return _slab.make_plan(n, d, SLAB, sms, resident)


def launch_plan(n: int, d: int, device) -> _slab.SlabPlan:
    """The plan the wrapper launches at (N, D) on CUDA ``device``."""
    return _slab.launch_plan(NEIGHBOR_SUM, OCCUPANCY, n, d, SLAB, device)


def occupancy(n: int, device) -> dict:
    """Resident blocks per SM, SMs, registers and local bytes per thread
    of the neighbor-sum kernel at N senders (the library's queries)."""
    return _slab.device_occupancy(NEIGHBOR_SUM, OCCUPANCY, n, device)


def fused_neighbor_sum(neighbor_idx: torch.Tensor,
                       neighbor_mask: torch.Tensor, coeff: torch.Tensor,
                       codes: torch.Tensor, scale: torch.Tensor,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Eq. 3's neighbor contraction straight from int8 wire codes.

    neighbor_idx (N, K_max) int32; neighbor_mask and edge_mask (N, K_max)
    float32; coeff (N,) float32; codes (N, D) int8; scale (N, 1) float32,
    the per-message decode scale; all on one device; D at most
    ``_checks.SLAB_MAX_COLUMNS``. Returns (N, D) float32.
    """
    check_columns("codes", codes, SLAB_MAX_COLUMNS)
    operands = [neighbor_idx, neighbor_mask, coeff, codes, scale]
    if edge_mask is not None:
        operands.append(edge_mask)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.fused_neighbor_sum_ref(neighbor_idx, neighbor_mask, coeff,
                                          codes, scale, edge_mask)
    n, d = codes.shape
    k_max = neighbor_idx.shape[1] if neighbor_idx.dim() == 2 else -1
    check_operand("neighbor_idx", neighbor_idx, torch.int32, (n, k_max))
    check_operand("codes", codes, torch.int8, (n, d))
    for name, t, shape in (("neighbor_mask", neighbor_mask, (n, k_max)),
                           ("coeff", coeff, (n,)), ("scale", scale, (n, 1)),
                           ("edge_mask", edge_mask, (n, k_max))):
        if t is not None:
            check_operand(name, t, torch.float32, shape)
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    if k_max == 0:
        return out.zero_()
    # the plain version gathers and accumulates: no dot FLOPs
    report("fused_neighbor_sum", 0.0, operands + [out])
    if fake:
        return out
    pl = launch_plan(n, d, codes.device)
    # phase 1's slot lists (int32 pairs) and their lengths
    lists = torch.empty(2 * pl.list_entries(k_max) + n * pl.chunks,
                        dtype=torch.int32, device=codes.device)
    NEIGHBOR_SUM.launch(neighbor_idx.data_ptr(), neighbor_mask.data_ptr(),
                        coeff.data_ptr(),
                        None if edge_mask is None else edge_mask.data_ptr(),
                        codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        lists.data_ptr(), n, k_max, d, pl.chunk_rows,
                        pl.chunks, pl.grid,
                        torch.cuda.current_stream(codes.device).cuda_stream)
    return out


def fused_neighbor_sum_rs(neighbor_idx: torch.Tensor,
                          neighbor_mask: torch.Tensor, w: torch.Tensor,
                          codes: torch.Tensor, scale: torch.Tensor,
                          theta: torch.Tensor) -> torch.Tensor:
    """Eq. 3 of R receivers over S senders' wire codes, before the
    α/(Nσ²) scale:

        out_j = Σ_k m_jk·w_i·(codes_i·scale_i) − (Σ_k m_jk·w_i)·θ_j,

    i = idx[j, k], over the slots in order, each product rounded before
    its add. neighbor_idx (R, K) int32 in [0, S); neighbor_mask (R, K)
    float32; w (S,) float32; codes (S, D) int8; scale (S, 1) float32;
    theta (R, D) float32; on one device. Returns (R, D) float32.
    """
    check_columns("codes", codes, RS_MAX_COLUMNS)
    operands = (neighbor_idx, neighbor_mask, w, codes, scale, theta)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.fused_neighbor_sum_rs_ref(*operands)
    r, d = theta.shape
    s = codes.shape[0]
    k_max = neighbor_idx.shape[1] if neighbor_idx.dim() == 2 else -1
    check_operand("neighbor_idx", neighbor_idx, torch.int32, (r, k_max))
    check_operand("codes", codes, torch.int8, (s, d))
    for name, t, shape in (("neighbor_mask", neighbor_mask, (r, k_max)),
                           ("w", w, (s,)), ("scale", scale, (s, 1)),
                           ("theta", theta, (r, d))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    if k_max == 0 or s == 0:
        return out.zero_()
    report("fused_neighbor_sum_rs", 0.0, operands + (out,))
    if fake:
        return out
    NEIGHBOR_SUM_RS.launch(neighbor_idx.data_ptr(), neighbor_mask.data_ptr(),
                           w.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                           theta.data_ptr(), out.data_ptr(), r, s, k_max, d,
                           torch.cuda.current_stream(theta.device)
                           .cuda_stream)
    return out


def fused_broadcast_select(codes: torch.Tensor, scale: torch.Tensor,
                           do_broadcast: torch.Tensor,
                           thetas: torch.Tensor) -> torch.Tensor:
    """``where(do_broadcast, codes · scale, thetas)`` in one pass: every
    agent adopts the decoded broadcast payload when the flag is set.

    codes (D,) int8; scale (1,) float32; do_broadcast () bool, read on the
    device; thetas (N, D) float32, D at most ``SELECT_MAX_COLUMNS``.
    Returns a new (N, D) float32 tensor.
    """
    check_columns("thetas", thetas, SELECT_MAX_COLUMNS)
    operands = (codes, scale, do_broadcast, thetas)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.broadcast_select_ref(codes, scale, do_broadcast, thetas)
    n, d = thetas.shape
    check_operand("codes", codes, torch.int8, (d,))
    check_operand("scale", scale, torch.float32, (1,))
    check_operand("do_broadcast", do_broadcast, torch.bool, ())
    check_operand("thetas", thetas, torch.float32, (n, d))
    out = torch.empty_like(thetas)
    if out.numel() == 0:
        return out
    report("fused_broadcast_select", 0.0, operands + (out,))
    if fake:
        return out
    BROADCAST_SELECT.launch(codes.data_ptr(), scale.data_ptr(),
                            do_broadcast.data_ptr(), thetas.data_ptr(),
                            out.data_ptr(), n, d,
                            torch.cuda.current_stream(thetas.device).cuda_stream)
    return out


# ---------------------------------------------------------------------------
# contract-linter registry hook (repro_torch.analysis)
# ---------------------------------------------------------------------------

def analysis_entry_points():
    """Contract-linter entry points for both fused wire kernels (on the
    card's fake tensors their shape-only paths) and the neighbor sum's
    plain version (the reference's ``.xla`` backend). Not under the
    fused-seam contract: every slot's product is rounded by the plain
    version and by the kernel alike (``ref.fused_neighbor_sum_ref``)."""
    from ..analysis.registry import EntryPoint

    def _wire_args(device, n=8, k=4, d=16):
        return (torch.zeros((n, k), dtype=torch.int32, device=device),
                torch.ones((n, k), dtype=torch.float32, device=device),
                torch.ones((n,), dtype=torch.float32, device=device),
                torch.zeros((n, d), dtype=torch.int8, device=device),
                torch.ones((n, 1), dtype=torch.float32, device=device))

    def build_neighbor_sum(device):
        return fused_neighbor_sum, _wire_args(device), {}

    def build_neighbor_sum_plain(device):
        return ref.fused_neighbor_sum_ref, _wire_args(device), {}

    def build_broadcast_select(device, d=16, n=8):
        return (fused_broadcast_select,
                (torch.zeros((d,), dtype=torch.int8, device=device),
                 torch.ones((1,), dtype=torch.float32, device=device),
                 torch.ones((), dtype=torch.bool, device=device),
                 torch.ones((n, d), dtype=torch.float32, device=device)),
                {})

    return (
        EntryPoint(name="kernels.fused_neighbor_sum",
                   build=build_neighbor_sum),
        EntryPoint(name="kernels.fused_neighbor_sum.plain",
                   build=build_neighbor_sum_plain),
        EntryPoint(name="kernels.fused_broadcast_select",
                   build=build_broadcast_select),
    )
