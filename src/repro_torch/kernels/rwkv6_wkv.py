"""RWKV-6 WKV recurrence with a data-dependent decay: the wrapper of
``csrc/rwkv6_wkv.cu``.

    out_t = r_t · (diag(u) · k_tᵀ v_t + S_{t−1})
    S_t   = diag(w_t) · S_{t−1} + k_tᵀ v_t

Replaces the TPU kernel ``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``, with
its signature and layout, and takes an initial state ``s0`` besides (the
TPU kernel starts from zero): prefill continues a cache, and a decode
step is the recurrence at S = 1. On CUDA tensors it launches the
hand-written sm_90a kernel (a block per (b, h, column group), see the
source's note; its launch is :func:`plan`'s); on CPU tensors it runs the
plain version ``ref.rwkv6_wkv_ref``. On fake and meta tensors (a dry
run's trace) it returns empty results of the kernel's shapes and reports
its costs (``_checks.report``), launching nothing. There is no other
path. Float32 only, head width n ≤ 64 (64 for every registry config; the
reference's tests use 8, 16 and 32).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref
from ._build import CudaKernel
from ._checks import (check_operand, has_dtensor, on_cpu, on_shards, report,
                      shape_only)

KERNEL = CudaKernel("rwkv6_wkv", "rwkv6_wkv_f32",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])

MAX_HEAD_DIM = 64     # what the kernel is built for

# the constants of csrc/rwkv6_wkv.cu, mirrored
CHUNK = 16            # steps staged at a time
# its instances (NP, RS, W): head width, threads sharing a column quad
# (NP / 4), computing warps per block
INSTANCES = ((8, 2, 1), (16, 4, 1), (32, 8, 2), (64, 16, 4))


def padded(n: int) -> int:
    """The head width of the instance that takes n channels."""
    return next(w for w in (8, 16, 32, 64) if n <= w)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A block per (b, h, column group) of a head of ``n`` channels (an
    instance's width: the wrapper pads heads to it): ``warps`` computing
    warps and one copying warp; RS = n / 4 threads share four state
    columns, each holding four rows of them, so ``cols`` = 4 · (32 / RS) ·
    warps columns a block and ⌈n / cols⌉ groups a head."""
    b: int
    h: int
    n: int
    rs: int
    warps: int

    @property
    def cols(self) -> int:
        return 4 * (32 // self.rs) * self.warps

    @property
    def groups(self) -> int:
        return -(-self.n // self.cols)

    @property
    def grid(self) -> int:
        return self.b * self.h * self.groups


def plan(b: int, h: int, n: int) -> Plan:
    """The launch for heads of n channels, padded to the instance's width.
    At n = 64 a block takes 32 columns with four computing warps: two
    blocks a head, 128 blocks at rwkv6-7b's B = 1 (one on each of 128 of
    the H100's 132 SMs). Narrower blocks with more of them, 256 blocks of
    16 columns (every SM busy, some with two), ran slower on the H100 at
    every shape tried."""
    np_ = padded(n)
    _, rs, warps = next(i for i in INSTANCES if i[0] == np_)
    return Plan(b=b, h=h, n=np_, rs=rs, warps=warps)


def block_work(pl: Plan, block: int) -> Tuple[int, int, range]:
    """(b, h, the state columns) of ``block``, as the kernel maps its
    block index."""
    bh, grp = divmod(block, pl.groups)
    b, h = divmod(bh, pl.h)
    return b, h, range(grp * pl.cols, min((grp + 1) * pl.cols, pl.n))


def thread_entries(pl: Plan, tid: int) -> Iterator[Tuple[int, int]]:
    """The (row, column) entries of the state that computing thread ``tid``
    of a block holds, columns relative to the block's first: rows
    4q .. 4q + 3 of columns 4g .. 4g + 3, q = lane mod RS and g its warp's
    quad, as the kernel lays them out; columns past n are padding."""
    lane = tid % 32
    quad = tid // 32 * (32 // pl.rs) + lane // pl.rs
    q = lane % pl.rs
    for col in range(4 * quad, 4 * quad + 4):
        for row in range(4 * q, 4 * q + 4):
            yield row, col


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def launch_info(b: int, s: int, h: int, n: int, device) -> dict:
    """The launch at (B, S, H, n) on CUDA ``device`` (n padded to the
    plan's width), from the library's query: grid (which must be the
    plan's), resident blocks per SM at its shared memory, registers and
    local (spill) bytes per thread of the kernel it runs (the step kernel
    at S = 1)."""
    pl = plan(b, h, n)
    fn = KERNEL.function("rwkv6_wkv_query", [ctypes.c_int] * 6
                         + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(_device_index(device)):
        err = fn(b, s, h, pl.n, pl.rs, pl.warps,
                 *(ctypes.byref(x) for x in vals))
    grid, resident, regs, local = (x.value for x in vals)
    if err != 0 or resident < 1 or grid != pl.grid:
        raise RuntimeError(f"rwkv6_wkv_query: cudaError_t {err}, {resident} "
                           f"resident blocks, grid {grid} against the plan's "
                           f"{pl.grid}")
    return {"rs": pl.rs, "warps": pl.warps, "cols": pl.cols,
            "groups": pl.groups, "grid": grid, "resident": resident,
            "registers": regs, "local_bytes": local}


def pad_heads(r, k, v, w, u, s0, pad: int):
    """The operands with ``pad`` zero channels appended to each head (new,
    aligned storage even at pad = 0). Zero channels leave the rest of the
    recurrence as it was: their state rows and columns stay 0, and so do
    their outputs."""
    def widen(t, dims):
        return F.pad(t, (0, pad) * dims) if pad else t.clone()
    return ([widen(t, 1) for t in (r, k, v, w, u)]
            + [None if s0 is None else widen(s0, 2)])


def flops(b: int, s: int, h: int, n: int) -> float:
    """The dot FLOPs of the plain version: each step's (1, n) × (n, n)
    read-out of the state, for every (b, h)."""
    return 2.0 * b * s * h * n * n


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None):
    """r, k, v, w (B, S, H, n) float32, w the decay in (0, 1); u (H, n)
    float32; s0 (B, H, n, n) float32 or None (a zero state). Returns
    (out (B, S, H, n) float32, final state (B, H, n, n) float32). DTensor
    operands run on each device's batch rows and heads."""
    if has_dtensor((r, k, v, w, u, s0)):
        return on_shards(rwkv6_wkv, (r, k, v, w, u, s0),
                         ((0, 2),) * 4 + ((None, 0), (0, 1)),
                         [(0, 2), (0, 1)])
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
    fake = shape_only([t for _, t, _ in operands])
    if not fake and on_cpu([t for _, t, _ in operands]):
        return ref.rwkv6_wkv_ref(r, k, v, w, u, s0)
    if fake:
        out = torch.empty_like(r)
        s_fin = torch.empty((b, h, n, n), dtype=torch.float32,
                            device=r.device)
    else:
        out, s_fin = _launch(r, k, v, w, u, s0)
    if b * h:
        report("rwkv6_wkv", flops(b, s, h, n),
               (r, k, v, w, u, s0, out, s_fin))
    return out, s_fin


def _launch(r, k, v, w, u, s0):
    """The kernel at the instance's head width, from 16-byte addresses
    (the operands padded when they are not)."""
    b, s, h, n = r.shape
    if n != padded(n) or any(t.data_ptr() % 16 for t in (r, k, v, w, u)) or (
            s0 is not None and s0.data_ptr() % 16):
        out, s_fin = _launch(*pad_heads(r, k, v, w, u, s0, padded(n) - n))
        return out[..., :n].contiguous(), s_fin[..., :n, :n].contiguous()
    out = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, s_fin
    pl = plan(b, h, n)
    KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), None if s0 is None else s0.data_ptr(),
                  out.data_ptr(), s_fin.data_ptr(), b, s, h, n, pl.rs,
                  pl.warps, torch.cuda.current_stream(r.device).cuda_stream)
    return out, s_fin
