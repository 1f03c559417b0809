"""Latent attention (MLA, DeepSeek-V2 and -V3; moonlight-16b-a3b), a
port-only mixer: the reference has no such layer.

For x (B, S, D) and H heads, with ``PortConfig``'s widths (nope, rope,
v, the latent r):

    q        = x W_q                      → H × (nope + rope)
    c, k_pe  = x W_kv_a                   → r, and one rope-wide key
    c        = RMSNorm(c)
    k_nope, v = c W_kv_b                  → H × (nope + v)
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)   (k_pe shared by every head)
    out      = softmax((q·k) / √(nope + rope)) v, causal;  then W_o

There is no query low-rank path (Moonlight's ``q_lora_rank`` is null).
The weights are matrices: ``wq`` (D, H·(nope + rope)), ``wkv_a`` (D, r +
rope), ``kv_norm`` (r,), ``wkv_b`` (r, H·(nope + v)), ``wo`` (H·v, D).
RoPE is the split-half rotation of ``layers.apply_rope`` where the
published modeling code rotates interleaved pairs: the two differ by a
fixed permutation of the rope columns of ``wq`` and ``wkv_a``, the same
for q and k, so with drawn weights they compute the same family. Its
angles and their cosines and sines are taken in float64 and rounded once
(``rope``): in float32, position × frequency loses up to 4e-4 rad at
position 4095, which moves the rotated columns by 2e-5 relative, 100 ×
float32's rounding.

``mla_block`` runs the attention through the flash kernel's 192/128
instance (``kernel=True``: ``loss_fn``'s path; the plain version on the
CPU) or through ``attention.blockwise_attention`` (the full forward, in
float64 a reference). Only full-sequence causal self-attention: the
latent decode cache is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import PortConfig
from ..kernels.flash_attention import flash_attention
from ..obs.regions import region
from . import attention, layers


@dataclasses.dataclass(frozen=True)
class MLASpec:
    num_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return self.qk_head_dim ** -0.5


def mla_spec(cfg: PortConfig) -> MLASpec:
    return MLASpec(num_heads=cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
                   qk_nope_head_dim=cfg.qk_nope_head_dim,
                   qk_rope_head_dim=cfg.qk_rope_head_dim,
                   v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
                   norm_eps=cfg.norm_eps)


def mla_init(gen: torch.Generator, d_model: int, spec: MLASpec, dtype):
    """Fan-in truncated normals, as ``attention.attn_init``; the latent's
    norm ones."""
    h, r = spec.num_heads, spec.kv_lora_rank
    return {
        "wq": layers.dense_init(gen, (d_model, h * spec.qk_head_dim), dtype),
        "wkv_a": layers.dense_init(gen, (d_model, r + spec.qk_rope_head_dim),
                                   dtype),
        "kv_norm": layers.rmsnorm_init(r, dtype, gen.device),
        "wkv_b": layers.dense_init(
            gen, (r, h * (spec.qk_nope_head_dim + spec.v_head_dim)), dtype),
        "wo": layers.dense_init(gen, (h * spec.v_head_dim, d_model), dtype),
    }


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """The split-half rotation of x (..., S, H, r) at ``positions`` (S,),
    the angles, cosines and sines in float64, rounded to x's dtype once."""
    r = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float64,
                                         device=x.device) / r)
    angles = positions.to(torch.float64)[:, None] * freqs     # (S, r/2)
    cos = torch.cos(angles).to(x.dtype)[:, None, :]          # (S, 1, r/2)
    sin = torch.sin(angles).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla_qkv(params, spec: MLASpec, x: torch.Tensor, positions: torch.Tensor):
    """q, k (B, S, H, nope + rope) and v (B, S, H, v) of ``x`` (B, S, D)
    at ``positions`` (S,)."""
    b, s, _ = x.shape
    h, nope, rp = spec.num_heads, spec.qk_nope_head_dim, \
        spec.qk_rope_head_dim
    q = (x @ params["wq"]).view(b, s, h, nope + rp)
    kv_a = x @ params["wkv_a"]
    c = layers.rmsnorm(params["kv_norm"], kv_a[..., :spec.kv_lora_rank],
                       eps=spec.norm_eps)
    k_pe = rope(kv_a[..., None, spec.kv_lora_rank:], positions,
                spec.rope_theta)                             # (B, S, 1, rope)
    kv = (c @ params["wkv_b"]).view(b, s, h, nope + spec.v_head_dim)
    q = torch.cat([q[..., :nope],
                   rope(q[..., nope:], positions, spec.rope_theta)],
                  dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, rp)], dim=-1)
    return q, k, kv[..., nope:]


def mla_block(params, spec: MLASpec, x: torch.Tensor,
              positions: torch.Tensor, kernel: bool) -> torch.Tensor:
    """Causal latent self-attention over a full sequence (module note),
    through the flash kernel if ``kernel``, else blockwise in the input's
    accumulation type."""
    with region("mla"):
        attention._check_arange(positions, x.shape[1])
        q, k, v = mla_qkv(params, spec, x, positions)
        if kernel:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True,
                                  scale=spec.scale)
        else:
            out = attention.blockwise_attention(
                attention.AttnSpec(num_heads=spec.num_heads,
                                   num_kv_heads=spec.num_heads,
                                   head_dim=spec.qk_head_dim),
                q, k, v, positions, positions)
        b, s = x.shape[:2]
        return out.reshape(b, s, -1) @ params["wo"]
