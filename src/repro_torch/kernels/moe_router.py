"""MoE top-k router: the wrapper of ``csrc/moe_router.cu``.

    p = softmax(logits); ids = the k largest p, ties to the lower index;
    gates = p[ids] / max(Σ p[ids], 1e-9)

Replaces the TPU kernel ``repro/kernels/moe_router.py::moe_topk``, with
its signature: logits (T, E) → (gates (T, k) float32, ids (T, k) int32).
On CUDA tensors it launches the hand-written sm_90a kernel (an instance
templated on (E, k) for moonshot's and jamba's routers, 64 / 6 and
16 / 2, and a generic one, which llama4's 16 / 1 and 128 / 1 take; see the
source's note); on CPU tensors it runs the plain
version ``ref.moe_topk_ref``. On fake and meta tensors (a dry run's trace) it
returns empty results of the kernel's shapes and reports its costs
(``_checks.report``), launching nothing. There is no other path. Float32 only,
E ≤ 128 and k ≤ 8 (the reference's tests use E ∈ {8, 16, 64, 128},
k ∈ {1, 2, 6, 8}).
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import CudaKernel
from ._checks import (check_operand, has_dtensor, on_cpu, on_shards, report,
                      shape_only)

KERNEL = CudaKernel("moe_router", "moe_topk_f32",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])

MAX_EXPERTS, MAX_K = 128, 8     # what the kernel is built for


def launch_info(t: int, e: int, k: int, device_index: int) -> dict:
    """The grid of the launch at (T, E, k) and its instance's resident
    blocks per SM, registers and local (spill) bytes per thread, from the
    library's query on CUDA device ``device_index``."""
    query = KERNEL.function("moe_topk_query", [ctypes.c_int] * 3
                            + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        err = query(t, e, k, *(ctypes.byref(x) for x in vals))
    grid, resident, regs, local = (x.value for x in vals)
    if err != 0 or resident < 1:
        raise RuntimeError(f"moe_topk_query: cudaError_t {err}, {resident} "
                           "resident blocks")
    return {"grid": grid, "resident": resident, "registers": regs,
            "local_bytes": local}


def moe_topk(logits: torch.Tensor, k: int):
    """logits (T, E) float32 → (gates (T, k) float32, ids (T, k) int32).
    A DTensor's tokens run on the devices that hold them."""
    if has_dtensor((logits,)):
        return on_shards(lambda x: moe_topk(x, k), (logits,), ((0, 0),),
                         [(0, 0), (0, 0)])
    if logits.dtype != torch.float32:
        raise TypeError(f"logits: dtype {logits.dtype}; moe_topk takes "
                        "float32 only")
    if logits.dim() != 2:
        raise ValueError(f"logits: shape {tuple(logits.shape)}, expected "
                         "(T, E)")
    t, e = logits.shape
    if not (1 <= e <= MAX_EXPERTS and 1 <= k <= min(e, MAX_K)):
        raise ValueError(f"E = {e}, k = {k}: the kernel takes E ≤ "
                         f"{MAX_EXPERTS} and 1 ≤ k ≤ min(E, {MAX_K})")
    fake = shape_only((logits,))
    if not fake and on_cpu((logits,)):
        return ref.moe_topk_ref(logits, k)
    check_operand("logits", logits, torch.float32, (t, e))
    gates = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    if t == 0:
        return gates, ids
    # the plain version is a softmax and a sort: no dot FLOPs
    report("moe_topk", 0.0, (logits, gates, ids))
    if fake:
        return gates, ids
    KERNEL.launch(logits.data_ptr(), gates.data_ptr(), ids.data_ptr(), t, e,
                  k, torch.cuda.current_stream(logits.device).cuda_stream)
    return gates, ids
