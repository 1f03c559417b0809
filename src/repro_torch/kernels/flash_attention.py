"""Blocked online-softmax attention with grouped-query heads: the wrapper
of ``csrc/flash_attention.cu``.

    out[b, q, h] = softmax_k(scale · q[b, q, h] · k[b, k, h // G] + mask) v[b, k, h // G]

with q and k of one head width and v of its own (latent attention's 192
and 128; every other instance has one width).

with the causal, sliding-window and chunked-local masks and padded keys
masked. Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``, with its signature and layout. On CUDA tensors it
launches the hand-written sm_90a kernel (a block per query tile of the G
heads of one KV head, see the source's note; its grid is :func:`plan`'s),
an instance per head width of ``HEAD_DIMS`` and per (query/key, value)
width pair of ``MIXED_WIDTHS``;
on CPU tensors it runs the plain version ``ref.flash_attention_ref``; on
fake and meta tensors (a dry run's trace) it returns an empty result and
reports its costs (:func:`flops`), launching nothing. There is no other
path. Float32 only.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Tuple

import torch

from . import ref
from ._build import CudaKernel
from ._checks import (check_operand, has_dtensor, on_cpu, on_shards, report,
                      shape_only)

KERNEL = CudaKernel(
    "flash_attention", "flash_attention_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p])

HEAD_DIMS = (32, 64, 128, 256)   # the head widths the kernel is built for
# the (query/key, value) widths of its instances whose two widths differ
MIXED_WIDTHS = ((192, 128),)


def rows_per_block(hd: int) -> int:
    """(position, head) rows of a block at query/key width ``hd``: the
    source's ``Tile<DK, DV>::BR`` (64 at hd 256, whose 128-row tiles would
    not fit in shared memory; 128 at hd 192, whose key tiles are 32
    keys)."""
    return 64 if hd == 256 else 128


@dataclasses.dataclass(frozen=True)
class Plan:
    """A block per (query tile, batch, KV head). A query tile is ``rows``
    consecutive rows of the (position, head) sequence of the G = H / Hkv
    query heads that read one KV head, position-major; each (batch, KV
    head) has ``tiles`` of them."""
    b: int
    sq: int
    h: int
    hkv: int
    rows: int
    tiles: int

    @property
    def grid_blocks(self) -> int:
        return self.tiles * self.hkv * self.b


def plan(b: int, sq: int, h: int, hkv: int, hd: int) -> Plan:
    br = rows_per_block(hd)
    return Plan(b=b, sq=sq, h=h, hkv=hkv, rows=br,
                tiles=-(-sq * (h // hkv) // br))


def block_rows(pl: Plan, block: int) -> Iterator[Tuple[int, int, int]]:
    """The (batch, position, query head) rows that ``block`` computes: the
    mapping the kernel makes from its block index. The query tile varies
    slowest and runs last-first, so that the longest causal tiles of every
    head are issued first."""
    g, heads = pl.h // pl.hkv, pl.hkv * pl.b
    r0 = (pl.tiles - 1 - block // heads) * pl.rows
    kvh, bb = block % heads % pl.hkv, block % heads // pl.hkv
    for row in range(r0, min(r0 + pl.rows, pl.sq * g)):
        yield bb, row // g, kvh * g + row % g


def launch_plan(b: int, sq: int, h: int, hkv: int, hd: int,
                hdv: int = 0) -> Tuple[Plan, int]:
    """The plan and the resident blocks per SM at this shape on the
    current card, from the library's query (whose grid must agree); the
    value width ``hdv`` is ``hd`` unless given."""
    query = KERNEL.function("flash_attention_query", [ctypes.c_int] * 6
                            + [ctypes.POINTER(ctypes.c_int)] * 2)
    grid, resident = ctypes.c_int(0), ctypes.c_int(0)
    err = query(b, sq, h, hkv, hd, hdv or hd, ctypes.byref(grid),
                ctypes.byref(resident))
    pl = plan(b, sq, h, hkv, hd)
    if err != 0 or grid.value != pl.grid_blocks:
        raise RuntimeError(f"flash_attention_query: cudaError_t {err}, grid "
                           f"{grid.value} against the plan's {pl.grid_blocks}")
    return pl, resident.value


def flops(b: int, sq: int, sk: int, h: int, hd: int, hdv: int = 0) -> float:
    """The dot FLOPs of the plain version: the dense Sq × Sk scores (at
    width ``hd``) and their product with v (at ``hdv``, ``hd`` unless
    given), whatever the mask skips (as the reference's jnp attention
    computes them)."""
    return 2.0 * b * h * sq * sk * (hd + (hdv or hd))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    scale=None) -> torch.Tensor:
    """q (B, Sq, H, hd); k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hdv), H a
    multiple of Hkv; all float32 on one device. Returns (B, Sq, H, hdv)
    float32; ``scale`` defaults to hd^-½. Query position
    i and key position j are the indices i and j. DTensor operands run on
    each device's batch rows and heads."""
    if has_dtensor((q, k, v)):
        return on_shards(
            lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                            window=window, chunk=chunk,
                                            scale=scale),
            (q, k, v), ((0, 2),) * 3, (0, 2))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; flash_attention "
                            "takes float32 only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    if window < 0 or chunk < 0:
        raise ValueError(f"window {window} and chunk {chunk} must be ≥ 0")
    if sk == 0:
        raise ValueError("attention over no keys")
    scale = scale or hd ** -0.5
    fake = shape_only((q, k, v))
    if not fake and on_cpu((q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk, scale=scale)
    check_operand("q", q, torch.float32, (b, sq, h, hd))
    check_operand("k", k, torch.float32, (b, sk, hkv, hd))
    check_operand("v", v, torch.float32, (b, sk, hkv, hdv))
    out = q.new_empty((b, sq, h, hdv))
    if out.numel() == 0:
        return out
    if not fake:
        if not ((hd == hdv and hd in HEAD_DIMS)
                or (hd, hdv) in MIXED_WIDTHS):
            raise ValueError(f"head widths {(hd, hdv)}: the kernel is built "
                             f"for {HEAD_DIMS} and {MIXED_WIDTHS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
    report("flash_attention", flops(b, sq, sk, h, hd, hdv), (q, k, v, out))
    if fake:
        return out
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, sk, h, hkv, hd, hdv, int(bool(causal)), int(window),
                  int(chunk), float(scale), plan(b, sq, h, hkv, hd).tiles,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
