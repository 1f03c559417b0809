"""Dense NetES mixing (paper Eq. 3): the wrapper of ``csrc/netes_mixing.cu``.

    out_j = Σ_i a_ji R̃θ_i (θ_i − θ_j) + σ Σ_i a_ji R̃ε_i ε_i

Replaces the TPU kernel ``repro/kernels/netes_mixing.py::netes_mixing``. On
CUDA tensors it launches the hand-written sm_90a kernel (a pre-pass that
weights and transposes the adjacency, a pipelined f32 GEMM over the stacked
source axis, and a fixed-order sum of the split tiles; see the source's
note); on CPU tensors it runs the plain version ``ref.netes_mixing_ref``.
On fake and meta tensors (a dry run's trace) it
returns empty results of the kernel's shapes and reports its costs
(``_checks.report``), launching nothing. There is no other path.

``netes_mixing_rs`` is the receiver ≠ sender instance of the sharded
fleet (``distributed.fleet_shard``): R receivers, S senders of a payload,
the sum in sender order with each product rounded, equal to the plain
version ``ref.netes_mixing_rs_ref`` bit for bit.

The launch plan (which output tiles run whole, how the tiles of the last,
partial wave are split along the source axis, and the scratch this takes)
is made here by :func:`plan` from the library's occupancy query.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterator, Tuple

import torch

from . import ref
from ._build import CudaKernel
from ._checks import (check_columns, check_operand, on_cpu, report,
                      shape_only)

KERNEL = CudaKernel(
    "netes_mixing", "netes_mixing_f32",
    [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 10
    + [ctypes.c_void_p])

# The receiver ≠ sender instance (``netes_mixing_rs``): R receivers over S
# senders, the sharded fleet's per-shard contraction.
KERNEL_RS = CudaKernel(
    "netes_mixing", "netes_mixing_rs_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
RS_BM = 64           # its output rows per block (the grid's y extent ≤ 65535)
RS_MAX_ROWS = 65535 * RS_BM

# The source's tile constants: output tile BM × BN, BK source rows per
# stage, WCHUNK source rows per block of the weighting pre-pass.
BM = BN = 128
BK = 16
WCHUNK = 64
MIN_PIECE_K_TILES = 4   # the shortest stretch of K a split piece walks
# The columns the GEMM's int arithmetic addresses: ``(p + BN − 1) / BN``
# and a tile's last column ``col0 + BN − 1`` stay below 2³¹.
MAX_COLUMNS = 2**31 - 1 - BN


@dataclasses.dataclass(frozen=True)
class Plan:
    n: int
    p: int
    kh: int          # rows of each half of the weighted operand
    npad: int        # its columns
    row_tiles: int
    col_tiles: int
    k_tiles: int
    w_chunks: int
    full: int        # tiles computed whole: blocks [0, full)
    split: int       # pieces of each remaining tile
    rem: int         # remaining tiles: blocks [full, full + rem·split)
    slots: int       # resident blocks on the card (SMs × blocks per SM)

    @property
    def grid_blocks(self) -> int:
        return self.full + self.rem * self.split

    @property
    def scratch_floats(self) -> int:
        return (2 * self.kh * self.npad + self.npad
                + self.rem * self.split * BM * BN)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, p: int, sms: int, resident_per_sm: int) -> Plan:
    """The launch plan at (N, P) on a card with ``sms`` SMs that holds
    ``resident_per_sm`` GEMM blocks each.

    The tiles that fill whole waves of resident blocks run whole. When the
    last wave is partial, each of its tiles is cut along K into ``split``
    pieces, as many as the free slots allow (each at least
    MIN_PIECE_K_TILES stages), so that the last wave too is (nearly) full.
    """
    row_tiles, col_tiles = _cdiv(n, BM), _cdiv(p, BN)
    tiles = row_tiles * col_tiles
    kh = _cdiv(n, BK) * BK
    k_tiles = 2 * kh // BK
    slots = sms * resident_per_sm
    rem = tiles % slots
    split = min(slots // rem, k_tiles // MIN_PIECE_K_TILES) if rem else 1
    if split <= 1:
        rem, split = 0, 1
    return Plan(n=n, p=p, kh=kh, npad=row_tiles * BM, row_tiles=row_tiles,
                col_tiles=col_tiles, k_tiles=k_tiles,
                w_chunks=_cdiv(kh, WCHUNK), full=tiles - rem, split=split,
                rem=rem, slots=slots)


def block_work(pl: Plan) -> Iterator[Tuple[int, int, int, int]]:
    """(row0, col0, kt0, kt1) for each block of the GEMM grid, in block
    order: the mapping ``mixing_gemm`` computes from ``blockIdx.x``."""
    for bid in range(pl.grid_blocks):
        if bid < pl.full:
            tile, kt0, kt1 = bid, 0, pl.k_tiles
        else:
            slab = bid - pl.full
            piece = slab % pl.split
            tile = pl.full + slab // pl.split
            kt0 = piece * pl.k_tiles // pl.split
            kt1 = (piece + 1) * pl.k_tiles // pl.split
        yield ((tile % pl.row_tiles) * BM, (tile // pl.row_tiles) * BN,
               kt0, kt1)


@functools.lru_cache(maxsize=None)
def occupancy(device_index: int) -> Tuple[int, int]:
    """(resident GEMM blocks per SM, SMs) of the card, from the library's
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` query."""
    query = KERNEL.function("netes_mixing_occupancy",
                            [ctypes.POINTER(ctypes.c_int)] * 2)
    resident, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = query(ctypes.byref(resident), ctypes.byref(sms))
    if err != 0 or resident.value < 1:
        raise RuntimeError(f"netes_mixing_occupancy: cudaError_t {err}, "
                           f"{resident.value} resident blocks")
    return resident.value, sms.value


def launch_plan(n: int, p: int, device) -> Plan:
    """The plan the wrapper launches at (N, P) on CUDA ``device``."""
    index = torch.device(device).index
    resident, sms = occupancy(torch.cuda.current_device() if index is None
                              else index)
    return plan(n, p, sms, resident)


def flops(n: int, p: int) -> float:
    """The dot FLOPs of the plain version: two (N, N) × (N, P) products
    and one (N, N) × (N,)."""
    return 4.0 * n * n * p + 2.0 * n * n


def netes_mixing(adj: torch.Tensor, w_theta: torch.Tensor,
                 w_eps: torch.Tensor, theta: torch.Tensor, eps: torch.Tensor,
                 *, sigma: float) -> torch.Tensor:
    """Eq. 3 over a dense adjacency, before the α/(Nσ²) scale.

    adj (N, N); w_theta, w_eps (N,); theta, eps (N, P); all float32 and
    contiguous on one device, P at most ``MAX_COLUMNS``. Returns (N, P)
    float32.
    """
    check_columns("theta", theta, MAX_COLUMNS)
    operands = (adj, w_theta, w_eps, theta, eps)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.netes_mixing_ref(*operands, sigma=sigma)
    n, p = theta.shape
    for name, t, shape in (("adj", adj, (n, n)), ("w_theta", w_theta, (n,)),
                           ("w_eps", w_eps, (n,)), ("theta", theta, (n, p)),
                           ("eps", eps, (n, p))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    report("netes_mixing", flops(n, p), operands + (out,))
    if fake:
        return out
    pl = launch_plan(n, p, theta.device)
    scratch = torch.empty(pl.scratch_floats, dtype=torch.float32,
                          device=theta.device)
    KERNEL.launch(adj.data_ptr(), w_theta.data_ptr(), w_eps.data_ptr(),
                  theta.data_ptr(), eps.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), float(sigma), n, p, pl.kh, pl.npad,
                  pl.row_tiles, pl.k_tiles, pl.w_chunks, pl.full, pl.split,
                  pl.rem, torch.cuda.current_stream(theta.device).cuda_stream)
    return out


def netes_mixing_rs(adj: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                    theta: torch.Tensor) -> torch.Tensor:
    """Eq. 3 of R receivers over S senders, before the α/(Nσ²) scale:

        out_j = Σ_s a_js·w_s·x_s − (Σ_s a_js·w_s)·θ_j,

    over s = 0 .. S − 1 in order, each product rounded before its add (so
    a row's bits do not depend on R or on which rows ride with it).

    adj (R, S) the receivers' rows of the adjacency; w (S,) the senders'
    weights; x (S, P) the senders' payload θ + σε; theta (R, P) the
    receivers' own θ; float32 and contiguous on one device, P at most
    ``MAX_COLUMNS``, R at most ``RS_MAX_ROWS``. Returns (R, P) float32.
    """
    check_columns("x", x, MAX_COLUMNS)
    operands = (adj, w, x, theta)
    fake = shape_only(operands)
    if not fake and on_cpu(operands):
        return ref.netes_mixing_rs_ref(*operands)
    r, p = theta.shape
    s = x.shape[0]
    if r > RS_MAX_ROWS:
        raise ValueError(f"theta: {r} receivers, more than the "
                         f"{RS_MAX_ROWS} the grid addresses")
    for name, t, shape in (("adj", adj, (r, s)), ("w", w, (s,)),
                           ("x", x, (s, p)), ("theta", theta, (r, p))):
        check_operand(name, t, torch.float32, shape)
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    if s == 0:
        return out.zero_()
    # the plain version sums source by source, elementwise: no dot FLOPs
    report("netes_mixing_rs", 0.0, operands + (out,))
    if fake:
        return out
    KERNEL_RS.launch(adj.data_ptr(), w.data_ptr(), x.data_ptr(),
                     theta.data_ptr(), out.data_ptr(), r, s, p,
                     torch.cuda.current_stream(theta.device).cuda_stream)
    return out
