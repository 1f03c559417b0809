"""Sparse NetES mixing (paper Eq. 3 over a padded neighbor list): the
wrapper of ``csrc/netes_sparse_mixing.cu``.

    out_j = Σ_k m_jk R̃θ_{i_jk} (θ_{i_jk} − θ_j) + σ Σ_k m_jk R̃ε_{i_jk} ε_{i_jk}

Replaces the TPU kernel
``repro/kernels/netes_sparse_mixing.py::netes_sparse_mixing``. On CUDA
tensors it launches one of the hand-written sm_90a kernel's two instances
of the factored sum Σ_k m_jk·Y[i_jk] − wsum_j·θ_j, Y = R̃θ·θ + σR̃ε·ε (see
below and the source's note); on CPU tensors it runs the plain version
``ref.sparse_mixing_ref``. On fake and meta tensors (a dry run's trace) it
returns empty results of the kernel's shapes and reports its costs
(``_checks.report``), launching nothing. There is no other path.

``netes_sparse_mixing_rs`` is the receiver ≠ sender instance of the
sharded fleet (``distributed.fleet_shard``): R receivers, S senders of a
payload, the slots in order with each product rounded (``csrc/_rows.cuh``),
equal to the plain version ``ref.sparse_mixing_rs_ref`` bit for bit.

Two instances of the square kernel, chosen by :func:`uses_band` from (N,
K_max) alone. The slab instance ``sparse_mixing_slab`` (the live slots
compacted into lists, then gathered from a slab of 32 columns of Y held in
shared memory; one cooperative launch; its plan, slab width, sender chunks
and grid, is made by :func:`plan`, ``kernels/_slab.py``, from the
library's occupancy query; :func:`block_work` is the per-block work it
computes; the wrapper allocates the lists' scratch) takes every N whose
senders fit one block's shared memory, and wider graphs. The band instance
``sparse_mixing_slab_l2`` (one plain launch, no scratch; :class:`BandPlan`,
:func:`band_work`) takes N past one chunk with short lists: a warp per
(receiver, band of ``BAND`` columns) gathers its senders' θ and ε straight from
L2, the bands in block order so the resident blocks share one band.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Tuple, Union

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

# The band instance (``sparse_mixing_slab_l2``): many chunks, few slots
KERNEL_BAND = CudaKernel(
    "netes_sparse_mixing", "netes_sparse_mixing_band_f32",
    [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p])
BAND_OCCUPANCY = "netes_sparse_mixing_band_occupancy"

SLAB = 32            # float32 columns of Y per slab: 128 bytes a sender

# the band instance's constants (csrc/netes_sparse_mixing.cu, namespace
# band), mirrored
BAND_THREADS = 256                 # a warp per (receiver, band)
BAND_WARPS = BAND_THREADS // 32
# W: columns of a band, 4 a lane; the band of θ and ε for all senders,
# N·W·8 bytes, is 16.8 MB at N = 16,384, a third of the H100's 50 MB L2
BAND = 128
# Past one chunk, the slab instance's time is its (slab, chunk, receiver)
# passes, ∝ P·chunks·N, and the band instance's its L2 gathers, ∝ P·nnz:
# the band instance takes a call where K_max ≤ 16·chunks. On the H100
# (PERF.md §6, row 2c) it was the faster at K_max/chunks up to 25.5 (N =
# 3000) and 16.5 (N = 16,384), and the slower at 35.8 (N = 5000) and 180.5
# (N = 3000): at 16 it takes only shapes where it measured faster.
BAND_SLOTS_PER_CHUNK = 16

block_work = _slab.block_work
chunk_bounds = _slab.chunk_bounds


def plan(n: int, p: int, sms: int, resident: int) -> _slab.SlabPlan:
    """The plan at (N, P) on a card of ``sms`` SMs holding ``resident``
    blocks each."""
    return _slab.make_plan(n, p, SLAB, sms, resident)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """The band instance's grid at (N, P): ``bands`` bands of ``BAND``
    columns, the last ragged where BAND does not divide P."""
    n: int             # senders = receivers
    cols: int          # P

    @property
    def bands(self) -> int:
        return -(-self.cols // BAND)

    @property
    def groups(self) -> int:
        """Blocks of one band: BAND_WARPS receivers each."""
        return -(-self.n // BAND_WARPS)

    @property
    def grid(self) -> int:
        return self.groups * self.bands


def band_work(pl: BandPlan) -> Iterator[Tuple[int, int, int]]:
    """For each block, in block order, its (band, r0, r1): the receivers
    [r0, r1) over that band's columns, as the kernel computes them from
    ``blockIdx.x``: band-major."""
    for blk in range(pl.grid):
        b, g = divmod(blk, pl.groups)
        yield b, g * BAND_WARPS, min(pl.n, (g + 1) * BAND_WARPS)


def uses_band(n: int, k_max: int) -> bool:
    """Whether a call at (N, K_max) takes the band instance: where the
    slab instance would cut the senders into chunks and K_max is at most
    ``BAND_SLOTS_PER_CHUNK`` a chunk. P does not enter: both instances'
    times scale with it alike."""
    chunks = _slab.chunking(n)[1]
    return chunks > 1 and k_max <= BAND_SLOTS_PER_CHUNK * chunks


def slab_plan(n: int, p: int, device) -> _slab.SlabPlan:
    """The slab instance's plan at (N, P) on CUDA ``device``."""
    return _slab.launch_plan(KERNEL, OCCUPANCY, n, p, SLAB, device)


def launch_plan(n: int, p: int, k_max: int,
                device) -> Union[_slab.SlabPlan, BandPlan]:
    """The plan the wrapper launches at (N, P, K_max) on CUDA ``device``:
    the band instance's or the slab instance's."""
    if uses_band(n, k_max):
        return BandPlan(n=n, cols=p)
    return slab_plan(n, p, device)


def occupancy(n: int, device) -> dict:
    """Resident blocks per SM, SMs, registers and local bytes per thread
    of the slab instance at N senders (the library's queries)."""
    return _slab.device_occupancy(KERNEL, OCCUPANCY, n, device)


def band_occupancy(device) -> dict:
    """The same of the band instance, which takes no shared memory."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    query = KERNEL_BAND.function(BAND_OCCUPANCY,
                                 [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(index):
        err = query(*(ctypes.byref(v) for v in vals))
    resident, sms, regs, local = (v.value for v in vals)
    if err != 0 or resident < 1:
        raise RuntimeError(f"{BAND_OCCUPANCY}: cudaError_t {err}, "
                           f"{resident} resident blocks")
    return {"resident": resident, "sms": sms, "registers": regs,
            "local_bytes": local}


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
    launch(launch_plan(n, p, k_max, theta.device), neighbor_idx,
           neighbor_mask, w_theta, w_eps, theta, eps, out, sigma=sigma)
    return out


def launch(pl: Union[_slab.SlabPlan, BandPlan], neighbor_idx, neighbor_mask,
           w_theta, w_eps, theta, eps, out, *, sigma: float) -> None:
    """One launch of the instance that ``pl`` plans, into ``out``, on the
    current stream; the operands as :func:`netes_sparse_mixing` checks
    them (this checks nothing)."""
    n, p = theta.shape
    k_max = neighbor_idx.shape[1]
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    ptrs = [t.data_ptr() for t in (neighbor_idx, neighbor_mask, w_theta,
                                   w_eps, theta, eps, out)]
    if isinstance(pl, BandPlan):
        KERNEL_BAND.launch(*ptrs, float(sigma), n, k_max, p, stream)
        return
    # phase 1's slot lists (int32 pairs), their lengths, and wsum per
    # (receiver, chunk)
    scratch = torch.empty(2 * pl.list_entries(k_max) + 2 * n * pl.chunks,
                          dtype=torch.int32, device=theta.device)
    KERNEL.launch(*ptrs, scratch.data_ptr(), float(sigma), n, k_max, p,
                  pl.chunk_rows, pl.chunks, pl.grid, stream)


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
