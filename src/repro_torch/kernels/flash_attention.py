"""Blocked online-softmax attention with grouped-query heads: the wrapper
of ``csrc/flash_attention.cu``.

    out[b, q, h] = softmax_k(scale · q[b, q, h] · k[b, k, h // G] + mask) v[b, k, h // G]

with the causal, sliding-window and chunked-local masks and padded keys
masked. Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``, with its signature and layout. On CUDA tensors it
launches the hand-written sm_90a kernel (see the source's note); on CPU
tensors it runs the plain version ``ref.flash_attention_ref``. There is no
other path. Float32 only.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import CudaKernel
from ._checks import check_operand, on_cpu

KERNEL = CudaKernel(
    "flash_attention", "flash_attention_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                  ctypes.c_void_p])

HEAD_DIMS = (64, 128)   # the head widths the kernel is built for


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    scale=None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd), H a multiple of Hkv; all
    float32 on one device. Returns (B, Sq, H, hd) float32. Query position
    i and key position j are the indices i and j."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; flash_attention "
                            "takes float32 only")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    if window < 0 or chunk < 0:
        raise ValueError(f"window {window} and chunk {chunk} must be ≥ 0")
    if sk == 0:
        raise ValueError("attention over no keys")
    scale = scale or hd ** -0.5
    if on_cpu((q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk, scale=scale)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for {HEAD_DIMS}")
    check_operand("q", q, torch.float32, (b, sq, h, hd))
    check_operand("k", k, torch.float32, (b, sk, hkv, hd))
    check_operand("v", v, torch.float32, (b, sk, hkv, hd))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, sk, h, hkv, hd, int(bool(causal)), int(window),
                  int(chunk), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
