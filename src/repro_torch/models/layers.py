"""Shared transformer building blocks: the port of ``repro/models/layers.py``.

Parameters are nested dicts of tensors, as the reference's pytrees. Every
init draws from an explicit ``torch.Generator`` and fills tensors on the
generator's device with the reference's statistics (the draws themselves
differ: the port does not reproduce threefry). Activations keep the dtype
of the parameters unless stated.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


class _ShapeOnlyGenerator(torch.Generator):
    """A CPU generator that reports the meta device: an init given it makes
    meta tensors of the init's shapes and dtypes and draws nothing (a meta
    tensor's fill is a no-op; ``torch.Generator`` itself has no meta
    device)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The inits' generator on ``device`` seeded with ``seed``; on the meta
    device a shape-only one (``launch.specs``' abstract trees)."""
    if device.type == "meta":
        gen = _ShapeOnlyGenerator()
    else:
        gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale`` × a standard normal cut to
    ±2, drawn by inverting its CDF as ``jax.random.truncated_normal`` does,
    in place (a 12B model's weights leave no room for temporaries)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    bound = math.erf(2.0 / _SQRT2)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    out.uniform_(-bound, bound, generator=gen).erfinv_().mul_(_SQRT2)
    return out.clamp_(-2.0, 2.0).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    out = torch.empty((vocab, d_model), dtype=torch.float32, device=gen.device)
    return out.normal_(generator=gen).mul_(0.02).to(dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 accumulation, or float64 for a float64 input (where the
    reference computes in float32, the port's float64 forward stays a
    float64 reference)."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The variance in float32; the ``rsqrt`` cast to ``x.dtype`` before
    the rescale multiply, in the reference's order (``layers.py:38-44``)."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"]


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S). The
    split-half rotation, computed in float32 (``layers.py:65-80``)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "w_in": dense_init(gen, (d_model, d_ff), dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, (d_ff, d_model), dtype),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy, logits (..., V) and int labels (...,), in
    the reference's order: log Σ exp(l − max) + max − l[label],
    accumulated in float32 (float64 for a float64 input)."""
    acc = acc_dtype(logits.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    sumexp = torch.exp((logits - m).to(acc)).sum(dim=-1)
    lse = torch.log(sumexp) + m[..., 0].to(acc)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - picked.to(acc)
