"""RWKV-6 "Finch" block (arXiv:2404.05892): the port of
``repro/models/rwkv6.py``. Attention-free time mix with a data-dependent
decay and a matrix-valued state per head.

Per head h (head_dim n), per step t:
    S_t = diag(w_t) · S_{t−1} + k_tᵀ v_t          (S: (n, n) state)
    o_t = r_t · (diag(u) · k_tᵀ v_t + S_{t−1})
with w_t = exp(−exp(decay_t)), and u the bonus of the current token.

Prefill and decode run the recurrence through the hand-written kernel
(``kernels.rwkv6_wkv``), seeded with the cache's state: one launch per
layer for a whole prompt, and one per layer per decode step.
``rwkv6_block`` (the full forward's time mix) runs the reference's
chunked form ``wkv6_chunked`` in plain PyTorch, in float64 for float64
parameters, so that the full forward is the float64 reference on the card.

What the reference does and the port keeps, as written:
  * one ``mix_lora`` output is shared by all five token-shift mixes;
  * ``ln_x`` is a LayerNorm over all of d, not RWKV's per-head GroupNorm;
  * ``wkv6_chunked`` divides k by the in-chunk decay product, exact only
    while that product stays far above its 1e-30 floor (it does at the
    reference's init, w ≈ 0.9975);
  * prefill's channel mix ignores the cache's ``channel_x_prev``
    (``transformer._prefill_layer``), while its time mix starts from the
    cache's ``x_prev``. The two agree for a zero cache, which is what
    serving passes.
The cache's state is replaced by the kernel's output (the reference
returns new arrays too); ``x_prev`` is a copy of the last input row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.context import on_shards
from ..kernels.ref import rwkv6_wkv_ref
from ..kernels.rwkv6_wkv import rwkv6_wkv
from ..launch import op_costs
from . import layers


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    num_heads: int
    lora_rank_decay: int = 0   # 0 ⇒ max(16, d_model // 128)
    lora_rank_mix: int = 0     # 0 ⇒ max(16, d_model // 64)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def rank_w(self) -> int:
        return self.lora_rank_decay or max(16, self.d_model // 128)

    @property
    def rank_mix(self) -> int:
        return self.lora_rank_mix or max(16, self.d_model // 64)


def _lora_init(gen: torch.Generator, d: int, rank: int, dtype):
    return {
        "a": layers.dense_init(gen, (d, rank), dtype, scale=0.01),
        "b": layers.dense_init(gen, (rank, d), dtype, scale=0.01),
        "bias": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }


def _lora(p, x: torch.Tensor) -> torch.Tensor:
    acc = layers.acc_dtype(x.dtype)
    return (torch.tanh(x @ p["a"]) @ p["b"]).to(acc) + p["bias"].to(acc)


def rwkv6_init(gen: torch.Generator, spec: RWKV6Spec, dtype):
    """The reference's parameters and statistics; ``decay_base``,
    ``bonus_u`` and the LoRA biases are float32 whatever ``dtype``."""
    d, dev = spec.d_model, gen.device
    return {
        # token-shift mix coefficients (static part) per r/k/v/w/g
        "mix": 0.5 * torch.ones((5, d), dtype=dtype, device=dev),
        "mix_lora": _lora_init(gen, d, spec.rank_mix, dtype),
        "wr": layers.dense_init(gen, (d, d), dtype),
        "wk": layers.dense_init(gen, (d, d), dtype),
        "wv": layers.dense_init(gen, (d, d), dtype),
        "wg": layers.dense_init(gen, (d, d), dtype),
        "wo": layers.dense_init(gen, (d, d), dtype),
        "decay_lora": _lora_init(gen, d, spec.rank_w, dtype),
        "decay_base": -6.0 * torch.ones((d,), dtype=torch.float32, device=dev),
        "bonus_u": 0.5 * torch.ones((spec.num_heads, spec.head_dim),
                                    dtype=torch.float32, device=dev),
        "ln_x": layers.layernorm_init(d, dtype, dev),
    }


def _time_shift(x: torch.Tensor,
                last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x shifted one step back along S; the first step sees ``last`` (or
    zeros)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _mix_inputs(params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift mixing (Finch §3.1). Returns the r, k,
    v, w, g pre-projection inputs, each (B, S, D)."""
    delta = x_prev - x
    base = x + delta * params["mix"][4][None, None].to(x.dtype)
    dyn = _lora(params["mix_lora"], base).to(x.dtype)       # (B, S, D)
    return [x + delta * (params["mix"][i][None, None].to(x.dtype) + dyn * 0.1)
            for i in range(5)]                               # xr xk xv xw xg


def wkv6_chunked(r, k, v, w, u, s0=None, chunk: int = 128):
    """Chunked-parallel WKV-6 (the reference's formulation): within a
    chunk the in-chunk keys enter through a masked product, the carried
    state through per-position cumulative decays. Falls back to the
    sequential loop (the reference's ``wkv6_scan_ref``, here the kernel's
    plain version) when S is not a multiple of ``chunk``. Computes in
    float32, or in float64 for float64 inputs."""
    acc = layers.acc_dtype(r.dtype)
    b, s, h, n = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, n, n), dtype=acc, device=r.device)
    if s % chunk != 0:
        return rwkv6_wkv_ref(r, k, v, w, u, s0)
    nc = s // chunk
    rc, kc, vc, wc = (t.reshape(b, nc, chunk, h, n).to(acc)
                      for t in (r, k, v, w))
    u = u.to(acc)
    # causal (strict lower-triangular) mask for in-chunk interactions
    tri = torch.tril(torch.ones((chunk, chunk), dtype=acc, device=r.device),
                     diagonal=-1)
    state = s0.to(acc)
    outs = []
    # the chunks are the same ops at the same shapes: under a folding
    # ``launch.op_costs`` recorder one is traced and counted nc times
    for c in op_costs.passes(nc):
        rt, kt, vt, wt = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,C,H,n)
        logw = torch.log(torch.clamp(wt, min=1e-38))
        cum = torch.cumsum(logw, dim=1)                # Π_{τ≤t} w_τ (log)
        dec_in = torch.exp(cum)                        # decay from chunk start
        dec_prev = torch.exp(cum - logw)               # Π_{τ<t} w_τ
        out_state = torch.einsum("bchn,bhnm->bchm", rt * dec_prev, state)
        # in-chunk keys: (r_t·Π_{τ<t} w) · (k_j / Π_{τ≤j} w)ᵀ, finite while
        # the in-chunk decay product stays above the 1e-30 floor
        k_scaled = kt / torch.clamp(dec_in, min=1e-30)
        att = torch.einsum("bchn,bdhn->bhcd", rt * dec_prev, k_scaled)
        att = att * tri[None, None]
        out_intra = torch.einsum("bhcd,bdhm->bchm", att, vt)
        # bonus (current token) term
        out_bonus = (rt * kt * u[None, None]).sum(-1, keepdim=True) * vt
        outs.append(out_state + out_intra + out_bonus)
        # S_out = (Π_chunk w) S_in + Σ_j (Π_{j<τ≤C} w) k_jᵀ v_j
        dec_all = torch.exp(cum[:, -1])                # (B, H, n)
        k_dec = kt * torch.exp(cum[:, -1:] - cum)
        kv = torch.einsum("bchn,bchm->bhnm", k_dec, vt)
        state = dec_all[..., None] * state + kv
    return torch.cat(outs * (nc // len(outs)), dim=1), state


def _rkvgw(params, spec: RWKV6Spec, x: torch.Tensor, x_prev: torch.Tensor):
    """The time mix's projections: r, k, v, w (B, S, H, n) and the gate g
    (B, S, D)."""
    b, s, _ = x.shape
    h, n = spec.num_heads, spec.head_dim
    xr, xk, xv, xw, xg = _mix_inputs(params, x, x_prev)
    r = (xr @ params["wr"]).reshape(b, s, h, n)
    k = (xk @ params["wk"]).reshape(b, s, h, n)
    v = (xv @ params["wv"]).reshape(b, s, h, n)
    g = F.silu(xg @ params["wg"])
    decay = params["decay_base"] + _lora(params["decay_lora"], xw)
    w = torch.exp(-torch.exp(decay)).reshape(b, s, h, n)    # (0, 1)
    return r, k, v, w, g


def _out(params, out: torch.Tensor, g: torch.Tensor, x: torch.Tensor):
    b, s, d = x.shape
    out = layers.layernorm(params["ln_x"], out.reshape(b, s, d).to(x.dtype))
    return (out * g) @ params["wo"]


def _kernel_wkv(params, r, k, v, w, s0):
    """The recurrence through the kernel, on float32 operands as the
    reference's WKV computes."""
    f32 = [t.to(torch.float32) for t in (r, k, v, w, params["bonus_u"])]
    return rwkv6_wkv(*f32, s0)


def rwkv6_block(params, spec: RWKV6Spec, x: torch.Tensor,
                chunk: int = 128) -> torch.Tensor:
    """Time-mix block, full sequence (the full forward), through the plain
    ``wkv6_chunked``. x: (B, S, D) → (B, S, D)."""
    r, k, v, w, g = _rkvgw(params, spec, x, _time_shift(x))
    # the recurrence is each (batch row, head)'s own: on a mesh every
    # device runs it on its rows and heads (context.on_shards)
    out, _ = on_shards(
        lambda r, k, v, w, u: wkv6_chunked(r, k, v, w, u, chunk=chunk),
        (r, k, v, w, params["bonus_u"]), ((0, 2),) * 4 + ((None, 0),),
        [(0, 2), (0, 1)])
    return _out(params, out, g, x)


def rwkv6_prefill(params, spec: RWKV6Spec, x: torch.Tensor, cache: dict):
    """Full-sequence time mix through the kernel that ALSO returns the
    decode cache: the final WKV state and the last input row, as S
    teacher-forced ``rwkv6_decode`` steps would leave them (the cache's
    ``x_prev`` and ``s`` seed the shift and the recurrence)."""
    r, k, v, w, g = _rkvgw(params, spec, x, _time_shift(x, cache["x_prev"]))
    out, s_fin = _kernel_wkv(params, r, k, v, w, cache["s"])
    y = _out(params, out, g, x)
    # a copy: a view of the last row would keep all of x alive in the cache
    return y, {"s": s_fin,
               "x_prev": x[:, -1:].to(cache["x_prev"].dtype, copy=True)}


def init_rwkv_cache(batch: int, spec: RWKV6Spec, dtype, device):
    return {
        "s": torch.zeros((batch, spec.num_heads, spec.head_dim,
                          spec.head_dim), dtype=torch.float32, device=device),
        "x_prev": torch.zeros((batch, 1, spec.d_model), dtype=dtype,
                              device=device),
    }


def rwkv6_decode(params, spec: RWKV6Spec, x: torch.Tensor, cache: dict):
    """One-token step through the kernel at S = 1. x: (B, 1, D)."""
    r, k, v, w, g = _rkvgw(params, spec, x, cache["x_prev"].to(x.dtype))
    out, s_new = _kernel_wkv(params, r, k, v, w, cache["s"])
    return _out(params, out, g, x), {"s": s_new, "x_prev": x}


# channel mix (RWKV's FFN variant with token shift + squared relu)

def rwkv6_channel_init(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    dev = gen.device
    return {
        "mix_k": 0.5 * torch.ones((d_model,), dtype=dtype, device=dev),
        "mix_r": 0.5 * torch.ones((d_model,), dtype=dtype, device=dev),
        "wk": layers.dense_init(gen, (d_model, d_ff), dtype),
        "wv": layers.dense_init(gen, (d_ff, d_model), dtype),
        "wr": layers.dense_init(gen, (d_model, d_model), dtype),
    }


def rwkv6_channel(params, x: torch.Tensor,
                  x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    xp = _time_shift(x, x_prev)
    xk = x + (xp - x) * params["mix_k"][None, None]
    xr = x + (xp - x) * params["mix_r"][None, None]
    kk = torch.square(F.relu(xk @ params["wk"]))
    return torch.sigmoid(xr @ params["wr"]) * (kk @ params["wv"])
