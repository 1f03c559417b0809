"""Encoded wire form of quantized channel payloads (DESIGN.md §12).

The port of ``repro.core.wire_format``. A quantizing channel's unfused path
(``comm.channel.Channel.apply``) quantizes and dequantizes at once, so the
mixing reads a full-width float32 payload. The wire form keeps what the
wire carries, int8 codes and one decode scale per message, so that the
fused contraction (``kernels/netes_fused_mixing``) reads the codes directly.

* ``codes`` — int8, the payload's shape: the rounded level in [−127, 127]
  (q8) or [−7, 7] (q4), or sign(x) ∈ {−1, 0, 1} (q1). Storage is one byte
  per element whatever ``bits`` is; ``Channel.elem_bytes`` models the
  narrower wire width.
* ``scale`` — float32, the payload's shape with the message axes reduced
  to 1: absmax/levels for q8 and q4, mean|x| for q1.

``decode`` is ``codes · scale`` for every mode, so it applies unchanged to
any aligned block of codes and scales.

``encode`` repeats ``comm.channel._quantize`` operation for operation, so
``decode(encode(x))`` equals ``_quantize(x)`` bit for bit. Every division
takes a tensor divisor on the payload's device: PyTorch's CUDA division by
a host scalar multiplies by its reciprocal instead, which rounds otherwise.
``torch.round`` rounds half to even, as ``jnp.round`` does.

``encode_columns`` encodes an (N, P) payload of N messages one column
slab at a time, bit for bit ``encode(x, bits, batched=True)`` for q8 and
q4: a leaf of billions of elements is encoded without a float temporary
of its size. ``slice_stack`` indexes a stacked payload's axis 1 in wire
form, as the reference's distributed replica step does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class WirePayload:
    """A quantized payload in wire form: ``value ≡ codes · scale``.

    ``dtype`` is the payload dtype the decode casts back to (what the
    fake-quant path returns).
    """

    codes: torch.Tensor          # int8, payload shape
    scale: torch.Tensor          # float32, payload shape, message axes -> 1
    dtype: torch.dtype = torch.float32

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.codes.shape)

    @property
    def ndim(self) -> int:
        return self.codes.ndim


def msg_axes(x: torch.Tensor, batched: bool) -> Tuple[int, ...]:
    """The axes of one message: all but the leading one when batched."""
    return tuple(range(1 if batched else 0, x.ndim))


def levels_of(bits: int, like: torch.Tensor) -> torch.Tensor:
    """2^(bits−1) − 1 as a float32 tensor on ``like``'s device."""
    return torch.full((), float(2 ** (bits - 1) - 1), dtype=torch.float32,
                      device=like.device)


def encode(x: torch.Tensor, bits: int, batched: bool) -> WirePayload:
    """Quantize ``x`` into wire form (see the module note on exactness)."""
    axes = msg_axes(x, batched)
    if bits == 1:
        scale = x.abs().mean(dim=axes, keepdim=True)
        codes = torch.sign(x)
    else:
        amax = x.abs().amax(dim=axes, keepdim=True)
        scale = amax / levels_of(bits, x)
        codes = torch.round(x / torch.where(scale > 0, scale,
                                            torch.ones_like(scale)))
    return WirePayload(codes=codes.to(torch.int8),
                       scale=scale.to(torch.float32), dtype=x.dtype)


def decode(codes: torch.Tensor, scale: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``codes · scale``, the one decode for every quantize mode, over any
    (codes, scale) pair of broadcastable shapes."""
    y = codes.to(torch.float32) * scale
    return y if dtype is None else y.to(dtype)


def decode_payload(wp: WirePayload) -> torch.Tensor:
    """Decode a whole ``WirePayload`` back to its payload dtype."""
    return decode(wp.codes, wp.scale, wp.dtype)


def encode_columns(x: torch.Tensor, bits: int, cols: int) -> WirePayload:
    """``encode(x, bits, batched=True)`` of an (N, ...) payload whose
    trailing axes are contiguous, taken ``cols`` columns of its (N, P)
    view at a time: the absmax is the max of the slabs' maxima and each
    slab's codes are the same elementwise quotients, so q8 and q4 come
    out bit for bit; q1's mean is not a max and takes the whole ``encode``.
    The scale has the payload's rank, as ``encode``'s."""
    if bits == 1 or x.ndim < 2:
        return encode(x, bits, batched=True)
    n = x.shape[0]
    flat = x.reshape(n, -1)
    amax = None
    for c0 in range(0, flat.shape[1], cols):
        m = flat[:, c0:c0 + cols].abs().amax(dim=1, keepdim=True)
        amax = m if amax is None else torch.maximum(amax, m)
    scale = amax / levels_of(bits, x)
    div = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    for c0 in range(0, flat.shape[1], cols):
        codes[:, c0:c0 + cols] = torch.round(flat[:, c0:c0 + cols] / div)
    return WirePayload(codes=codes.reshape(x.shape),
                       scale=scale.reshape((n,) + (1,) * (x.ndim - 1)),
                       dtype=x.dtype)


def slice_stack(wp: WirePayload, r: int) -> WirePayload:
    """Index a stacked payload's axis 1 (``(N, R, rest…) -> (N, rest…)``)
    keeping wire form. ``scale``'s axis 1 has size 1 (the message axes are
    reduced), so it is indexed at 0."""
    return WirePayload(codes=wp.codes[:, r], scale=wp.scale[:, 0],
                       dtype=wp.dtype)
