"""Mamba selective-SSM block (Jamba's SSM half, arXiv:2403.19887): the port
of ``repro/models/mamba.py``.

State-space recurrence (per channel c, state n):
    h_t = exp(Δ_t · A)  ⊙ h_{t−1} + Δ_t · B_t · x_t
    y_t = C_t · h_t + D ⊙ x_t
with input-dependent Δ, B, C (the "selective" part).

``mamba_prefill`` and ``mamba_decode`` run the recurrence through the
hand-written kernel (``kernels.mamba_scan``): one launch per layer over a
whole prompt from a zero state, and one per layer per decode step from the
cached state. ``mamba_block`` (the full forward's mixer) runs the
reference's associative form in plain PyTorch (a log-depth doubling scan,
and for sequences longer than ``chunk`` a loop over chunks that carries
the state), in float64 for float64 parameters, so that the full forward is
the float64 reference on the card.

Where the reference computes in float32 whatever the dtype (Δ, B, C, the
recurrence, the ``D`` skip), the port computes in ``layers.acc_dtype``:
float32 for float32, float64 for float64. The cache's state and conv ring
are tensors of their own, not views of the prompt's activations.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan
from ..launch import op_costs
from . import layers


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 ⇒ ceil(d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_init(gen: torch.Generator, spec: MambaSpec, dtype):
    """The reference's parameters and statistics; ``dt_bias``, ``A_log``
    and ``D`` are float32 whatever ``dtype``."""
    di, ds, r, dev = spec.d_inner, spec.d_state, spec.rank, gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    a = torch.arange(1, ds + 1, **f32)[None, :].repeat(di, 1)
    return {
        "in_x": layers.dense_init(gen, (spec.d_model, di), dtype),
        "in_z": layers.dense_init(gen, (spec.d_model, di), dtype),
        "conv_w": layers.dense_init(gen, (spec.d_conv, di), dtype, scale=0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": layers.dense_init(gen, (di, r + 2 * ds), dtype),
        "dt_proj": layers.dense_init(gen, (r, di), dtype),
        "dt_bias": torch.log(torch.expm1(0.01 * torch.ones((di,), **f32))),
        "A_log": torch.log(a),                        # (di, ds)
        "D": torch.ones((di,), **f32),
        "out_proj": layers.dense_init(gen, (di, spec.d_model), dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) for every x, as ``jax.nn.softplus`` (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(params, spec: MambaSpec, u: torch.Tensor):
    """x/z projections from the residual stream u: (B, S, D)."""
    return u @ params["in_x"], u @ params["in_z"]


def _selective_terms(params, spec: MambaSpec, x: torch.Tensor):
    """x: (B, S, di) post-conv. Returns decay (B,S,di,ds), drive
    (B,S,di,ds), C (B,S,ds), in ``acc_dtype(x.dtype)``. The two large
    products are made in place on their one allocation each."""
    acc = layers.acc_dtype(x.dtype)
    r, ds = spec.rank, spec.d_state
    proj = x @ params["x_proj"]                            # (B,S,r+2ds)
    dt = proj[..., :r] @ params["dt_proj"]                 # (B,S,di)
    dt = _softplus(dt.to(acc) + params["dt_bias"].to(acc))
    b = proj[..., r:r + ds].to(acc)                        # (B,S,ds)
    c = proj[..., r + ds:].to(acc)                         # (B,S,ds)
    a = -torch.exp(params["A_log"].to(acc))                # (di,ds)
    decay = torch.mul(dt[..., None], a[None, None]).exp_()  # (B,S,di,ds)
    drive = torch.mul(dt[..., None], b[..., None, :]).mul_(
        x.to(acc)[..., None])
    return decay, drive, c


def _causal_conv(params, spec: MambaSpec, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S. x: (B, S, di)."""
    w = params["conv_w"]                                   # (K, di)
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None] for i in range(k))
    return F.silu(out + params["conv_b"])


def associative_scan(decay: torch.Tensor, drive: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's associative scan of (decay, drive) over axis 1 with
    ``combine((da, xa), (db, xb)) = (da·db, xb + db·xa)``, as a log-depth
    doubling (Hillis–Steele) scan: after the step of offset o every
    position holds the combination of the 2o positions up to it. Returns
    (cumulative decay Π_{τ≤t} decay_τ, h_t from a zero state)."""
    a, h = decay.clone(), drive.clone()
    s = h.shape[1]
    off = 1
    while off < s:
        # each right-hand side is a new tensor made before the in-place
        # update, so every position reads the previous step's values
        h[:, off:] += a[:, off:] * h[:, :-off]
        a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return a, h


def mamba_scan_ref(decay: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """Associative scan of h_t = decay_t ⊙ h_{t−1} + drive_t over axis 1.

    decay, drive: (B, S, di, ds) → h: (B, S, di, ds)."""
    return associative_scan(decay, drive)[1]


def _contract_c(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y = Σ_n h[..., d, n] · c[..., n]: (…, di, ds), (…, ds) → (…, di)."""
    return torch.matmul(h, c[..., None])[..., 0]


def _output(params, x: torch.Tensor, y: torch.Tensor, xc: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    acc = y.dtype
    y = y + params["D"].to(acc)[None, None] * xc.to(acc)
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]


def mamba_block(params, spec: MambaSpec, x: torch.Tensor,
                chunk: int = 1024) -> torch.Tensor:
    """Full-sequence mixer (the full forward), plain PyTorch. x: (B, S, D)
    → (B, S, D).

    Sequences longer than ``chunk`` run as a loop over chunks carrying the
    SSM state, with the associative scan within each chunk, as the
    reference's ``lax.scan`` over chunks: the (B, S, di, ds) state is
    never made for the whole sequence."""
    b, s, _ = x.shape
    xin, z = _ssm_inputs(params, spec, x)
    xc = _causal_conv(params, spec, xin)                   # (B,S,di)

    if s <= chunk:
        decay, drive, c = _selective_terms(params, spec, xc)
        h = mamba_scan_ref(decay, drive)                   # (B,S,di,ds)
        del decay, drive
        y = _contract_c(h, c)                              # (B,S,di)
    else:
        if s % chunk:
            raise ValueError(f"seq {s} not divisible by chunk {chunk}")
        acc = layers.acc_dtype(x.dtype)
        h_prev = torch.zeros((b, spec.d_inner, spec.d_state), dtype=acc,
                             device=x.device)
        ys = []
        # one chunk traced under a folding ``launch.op_costs`` recorder
        for i in op_costs.passes(s // chunk):
            start = i * chunk
            decay, drive, c = _selective_terms(
                params, spec, xc[:, start:start + chunk])
            cumdec, hloc = associative_scan(decay, drive)
            del decay, drive
            h = hloc + cumdec * h_prev[:, None]            # (B,chunk,di,ds)
            del cumdec, hloc
            ys.append(_contract_c(h, c))
            h_prev = h[:, -1].clone()
            del h
        y = torch.cat(ys * (s // chunk // len(ys)), dim=1)
    return _output(params, x, y, xc, z)


def _kernel_scan(decay: torch.Tensor, drive: torch.Tensor, h0=None):
    """The recurrence through the kernel, on float32 operands as the
    reference's scan computes."""
    return mamba_scan(decay.to(torch.float32), drive.to(torch.float32),
                      None if h0 is None else h0.to(torch.float32))


def mamba_prefill(params, spec: MambaSpec, x: torch.Tensor, cache: dict):
    """Full-sequence mixer through the kernel that ALSO returns the decode
    cache: the final SSM state and conv ring exactly as S teacher-forced
    ``mamba_decode`` steps would have left them from a zero cache (the
    ring holds the last ``d_conv − 1`` pre-conv inputs, zero-padded for
    short prompts). As in the reference, the prompt starts from a zero
    state and ring whatever the cache holds; the cache gives the dtypes."""
    b, s, _ = x.shape
    xin, z = _ssm_inputs(params, spec, x)                  # (B,S,di)
    xc = _causal_conv(params, spec, xin)
    decay, drive, c = _selective_terms(params, spec, xc)
    h = _kernel_scan(decay, drive)                         # (B,S,di,ds)
    del decay, drive
    y = _contract_c(h.to(c.dtype), c)
    # copies: views of the last step would keep all of h and xin alive
    h_last = h[:, -1].clone(memory_format=torch.contiguous_format).to(
        cache["h"].dtype)
    del h
    out = _output(params, x, y, xc, z)

    k = spec.d_conv - 1
    ring = torch.cat([xin.new_zeros((b, max(k - s, 0), spec.d_inner)),
                      xin[:, max(s - k, 0):]], dim=1)
    return out, {"h": h_last, "conv": ring.to(cache["conv"].dtype)}


def init_mamba_cache(batch: int, spec: MambaSpec, dtype, device):
    return {
        "h": torch.zeros((batch, spec.d_inner, spec.d_state),
                         dtype=layers.acc_dtype(dtype), device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                            dtype=dtype, device=device),
    }


def mamba_decode(params, spec: MambaSpec, x: torch.Tensor, cache: dict):
    """One-token step through the kernel at S = 1 from the cached state.
    x: (B, 1, D)."""
    xin, z = _ssm_inputs(params, spec, x)                  # (B,1,di)
    buf = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)], dim=1)
    conv = (buf * params["conv_w"][None]).sum(dim=1, keepdim=True)
    xc = F.silu(conv + params["conv_b"])                   # (B,1,di)
    decay, drive, c = _selective_terms(params, spec, xc)
    h = _kernel_scan(decay, drive, cache["h"])[:, 0]       # (B,di,ds)
    y = _contract_c(h.to(c.dtype), c[:, 0])[:, None]
    out = _output(params, x, y, xc, z)
    return out, {"h": h.to(cache["h"].dtype), "conv": buf[:, 1:]}
