"""Launch plans of the two sparse Eq. 3 kernels, ``csrc/netes_sparse_mixing.cu``
and ``fused_neighbor_sum`` in ``csrc/netes_fused_mixing.cu``, whose shared
design is the header ``csrc/_slab.cuh``.

Both run in two phases of one cooperative launch. Phase 1 compacts each
receiver's live slots, per sender chunk, into a list of (row offset,
weight) in a scratch buffer; phase 2 holds a column slab of the senders in
shared memory and gathers each receiver's listed rows from there. A slab
row is 128 bytes in both: 32 float32 columns of Y (sparse mixing) or 64
bf16 widened codes (fused sum).

Phase 2's work is the list of (slab, receiver) units in slab-major order,
u = slab·N + receiver; block b of a grid of G blocks takes the units
[b·U/G, (b+1)·U/G) with U = slabs·N (integer division, as the kernels
compute it). Within a block, a run of units of one slab is a segment; for
each segment the block walks the sender chunks in order: it stages rows
[c0, c1) of the slab, then every receiver of the segment takes its list
for the chunk. When N rows do not fit in shared memory, the senders are
cut into ``chunks`` chunks of ``chunk_rows`` rows (the last may be
shorter).

Shared memory of a block, in this order (``csrc/_slab.cuh`` lays it out
the same): the warps' slot rings (WARPS × RING rounds of ROUND entries of
8 bytes), each round's count and flag (WARPS × RING ints, padded to 16
bytes), then chunk_rows + 1 slab rows of 128 bytes (the last row is zeros:
the lists' dummy entries point at it).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterator, List, Tuple

import torch

# the constants of csrc/_slab.cuh (namespace slab), mirrored
THREADS = 512
WARPS = THREADS // 32
ROW_BYTES = 128                    # one slab row of one sender
SLOT_BYTES = 8                     # a list entry: (row offset, weight)
ROUND = 128                        # list entries a warp copies at once
RING = 2                           # rounds in flight per warp
SMEM_MAX = 232_448                 # dynamic shared memory one block may use


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    n: int             # senders = receivers
    cols: int          # P (or D) columns of the operand
    slab: int          # columns per slab
    chunk_rows: int    # sender rows staged at once
    chunks: int
    grid: int          # blocks
    resident: int      # blocks per SM at smem_bytes (occupancy query)
    sms: int

    @property
    def slabs(self) -> int:
        return _cdiv(self.cols, self.slab)

    @property
    def units(self) -> int:
        return self.slabs * self.n

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.chunk_rows)

    def list_entries(self, k_max: int) -> int:
        """Entries of phase 1's lists: ⌈K_max/8⌉·8 per (receiver, chunk)."""
        return self.n * self.chunks * _cdiv(k_max, 8) * 8


def smem_bytes(rows: int) -> int:
    return (WARPS * RING * ROUND * SLOT_BYTES
            + _cdiv(WARPS * RING * 4, 16) * 16 + (rows + 1) * ROW_BYTES)


def chunking(n: int) -> Tuple[int, int]:
    """(chunk_rows, chunks): the fewest chunks whose rows fit in SMEM_MAX,
    of equal size but the last."""
    max_rows = (SMEM_MAX - smem_bytes(0)) // ROW_BYTES
    chunks = max(1, _cdiv(n, max_rows))
    return max(1, _cdiv(n, chunks)), chunks


def make_plan(n: int, cols: int, slab: int, sms: int,
              resident: int) -> SlabPlan:
    """The plan at (N, cols) on a card of ``sms`` SMs holding ``resident``
    blocks each at this plan's shared memory: one block per resident
    slot (a cooperative launch), never more blocks than units."""
    rows, chunks = chunking(n)
    units = _cdiv(cols, slab) * n
    return SlabPlan(n=n, cols=cols, slab=slab, chunk_rows=rows, chunks=chunks,
                    grid=max(1, min(sms * resident, units)),
                    resident=resident, sms=sms)


def chunk_bounds(pl: SlabPlan) -> List[Tuple[int, int]]:
    """[c0, c1) of each sender chunk, in the order the kernels stage them."""
    return [(c * pl.chunk_rows, min(pl.n, (c + 1) * pl.chunk_rows))
            for c in range(pl.chunks)]


def block_work(pl: SlabPlan) -> Iterator[List[Tuple[int, int, int]]]:
    """For each block, in block order, its segments (slab, r0, r1): the
    receivers [r0, r1) of one slab, as the kernels compute them from
    ``blockIdx.x``."""
    for b in range(pl.grid):
        u0 = pl.units * b // pl.grid
        u1 = pl.units * (b + 1) // pl.grid
        segs, u = [], u0
        while u < u1:
            s = u // pl.n
            segs.append((s, u - s * pl.n, min(pl.n, u1 - s * pl.n)))
            u = (s + 1) * pl.n
        yield segs


@functools.lru_cache(maxsize=None)
def occupancy(kernel, symbol: str, smem: int, device_index: int) -> dict:
    """Blocks per SM at ``smem`` bytes, SMs, registers per thread and
    local (spill) bytes per thread of a slab kernel, from its library's
    query (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes``)."""
    query = kernel.function(symbol, [ctypes.c_int]
                            + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        err = query(smem, *(ctypes.byref(v) for v in vals))
    resident, sms, regs, local = (v.value for v in vals)
    if err != 0 or resident < 1:
        raise RuntimeError(f"{symbol}: cudaError_t {err}, {resident} "
                           f"resident blocks at {smem} bytes")
    return {"resident": resident, "sms": sms, "registers": regs,
            "local_bytes": local}


def device_occupancy(kernel, symbol: str, n: int, device) -> dict:
    """:func:`occupancy` at the shared memory of N senders on ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return occupancy(kernel, symbol, smem_bytes(chunking(n)[0]), index)


def launch_plan(kernel, symbol: str, n: int, cols: int, slab: int,
                device) -> SlabPlan:
    """The plan a wrapper launches at (N, cols) on CUDA ``device``."""
    occ = device_occupancy(kernel, symbol, n, device)
    return make_plan(n, cols, slab, occ["sms"], occ["resident"])
