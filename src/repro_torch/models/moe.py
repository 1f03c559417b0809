"""Mixture-of-Experts FFN with group-wise capacity dispatch (GShard-style):
the port of ``repro/models/moe.py``.

Dispatch is gather-based (a stable sort and fixed-capacity index
matrices), not the one-hot-einsum formulation. Tokens are processed in
groups (sub-sequences of ``min(group_size, S)`` tokens); capacity is
enforced per group, so a choice that overflows its expert's capacity is
dropped and adds nothing (the token passes through the residual only).

The reference maps one group's routing over the groups with ``vmap``; the
port does all groups at once: one stable sort of ``group·E + expert``
gives each group's slots as the reference's per-group sort does, and the
expert products are batched matrix products over (E, groups·C, D).

The router's top-k runs through ``kernels.moe_router.moe_topk`` (the
hand-written kernel on the card) unless the caller passes another
function of its signature: the full forward passes the plain
``ref.moe_topk_ref``, so that it also runs in float64 as a reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..distributed.context import on_shards
from ..kernels.moe_router import moe_topk
from ..kernels.ref import moe_topk_ref
from . import layers


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    experts_per_token: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    group_size: int = 512
    router_jitter: float = 0.0


def moe_init(gen: torch.Generator, spec: MoESpec, dtype):
    """The reference's statistics: ``dense_init`` takes fan_in = shape[0],
    which for the expert tensors (E, d, f) is E, as in the reference. The
    router is float32 whatever ``dtype``."""
    e, d, f = spec.num_experts, spec.d_model, spec.d_ff
    return {
        "router": layers.dense_init(gen, (d, e), torch.float32),
        "w_gate": layers.dense_init(gen, (e, d, f), dtype),
        "w_up": layers.dense_init(gen, (e, d, f), dtype),
        "w_down": layers.dense_init(gen, (e, f, d), dtype),
    }


def group_capacity(spec: MoESpec, group: int) -> int:
    c = int(group * spec.experts_per_token * spec.capacity_factor
            / spec.num_experts)
    return max(c, spec.experts_per_token)


def _dispatch_indices(expert_ids: torch.Tensor, k: int, num_experts: int,
                      capacity: int):
    """Routing bookkeeping of each group.

    expert_ids: (G, g, k) integer — the chosen experts of each token of
    each group. Returns (idx, dst): idx (G, E, C) the token of each slot
    (g ⇒ empty), dst (G, g, k) the slot each (token, choice) landed in
    (E·C ⇒ dropped). Within an expert the choices keep their (token,
    choice) order, as the reference's stable per-group sort keeps them.
    """
    n_groups, g = expert_ids.shape[:2]
    dev = expert_ids.device
    ec = num_experts * capacity
    flat_e = expert_ids.reshape(n_groups, g * k).long()
    group = torch.arange(n_groups, device=dev)[:, None]
    key = (group * num_experts + flat_e).reshape(-1)
    order = torch.sort(key, stable=True).indices           # (G·g·k,)
    sorted_key = key[order]
    ar = torch.arange(key.numel(), device=dev)
    # position within each (group, expert) segment: arange − its start
    is_start = torch.ones_like(sorted_key, dtype=torch.bool)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    pos = ar - seg_start
    sorted_e = sorted_key % num_experts
    sorted_g = sorted_key // num_experts
    sorted_t = (order % (g * k)) // k                       # token in group
    dst = torch.where(pos < capacity, sorted_e * capacity + pos, ec)
    # one padded row of E·C + 1 slots per group; the last takes the drops
    idx = torch.full((n_groups, ec + 1), g, dtype=torch.long, device=dev)
    idx[sorted_g, dst] = sorted_t
    dst_orig = torch.empty_like(dst)
    dst_orig[order] = dst
    return (idx[:, :ec].reshape(n_groups, num_experts, capacity),
            dst_orig.reshape(n_groups, g, k))


def _router_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x @ router in float32, or in float64 for a float64 input."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ params["router"].to(acc)


def moe_block(params, spec: MoESpec, x: torch.Tensor,
              topk: Callable = moe_topk) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D), in groups of ``min(group_size, S)``
    tokens, each with ``group_capacity`` slots per expert."""
    b, s, d = x.shape
    e, k = spec.num_experts, spec.experts_per_token
    group = min(spec.group_size, s)
    if s % group:
        raise ValueError(f"seq {s} not divisible by group {group}")
    n_groups = b * s // group
    cap = group_capacity(spec, group)
    xg = x.reshape(n_groups, group, d)
    # the routing, the dispatch and the combine are each group's own: on
    # a mesh every device runs them on its groups (context.on_shards), the
    # router on its tokens of them
    gates, ids = on_shards(lambda lg: _route(lg, topk, k),
                           (_router_logits(params, xg),), ((0, 1),),
                           [(0, 1), (0, 1)])
    idx, dst = on_shards(lambda i: _dispatch_indices(i, k, e, cap),
                         (ids,), (0,), [0, 0])
    xe = on_shards(_gather_slots, (xg, idx), (0, 0), 0)    # (G, E·C, D)
    xe = xe.reshape(n_groups, e, cap, d).transpose(0, 1).reshape(
        e, n_groups * cap, d)
    h = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    y = torch.bmm(F.silu(h) * u, params["w_down"])            # (E, G·C, D)
    y = y.reshape(e, n_groups, cap, d).transpose(0, 1).reshape(
        n_groups, e * cap, d)
    out = on_shards(_combine, (y, dst, gates), (0, 0, 0), 0)
    return out.reshape(b, s, d).to(x.dtype)


def _route(logits: torch.Tensor, topk: Callable, k: int):
    """The router's top-k of (G, g, E) logits: (gates, ids), each (G, g,
    k)."""
    gates, ids = topk(logits.reshape(-1, logits.shape[-1]), k)
    return (gates.reshape(logits.shape[:2] + (k,)),
            ids.reshape(logits.shape[:2] + (k,)))


def _gather_slots(xg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each group's tokens in its expert slots: (G, g, D), idx (G, E, C)
    → (G, E·C, D), an empty slot (index g) a row of zeros."""
    n_groups, _, d = xg.shape
    xp = torch.cat([xg, xg.new_zeros(n_groups, 1, d)], dim=1)  # pad row
    rows = torch.arange(n_groups, device=xg.device)[:, None]
    return xp[rows, idx.reshape(n_groups, -1)]


def _combine(y: torch.Tensor, dst: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s slot of the experts' output y (G, E·C, D),
    weighted by its gate (G, g, k) and summed over the choices: (G, g,
    D); a dropped choice (slot E·C) adds 0."""
    n_groups, _, d = y.shape
    y = torch.cat([y, y.new_zeros(n_groups, 1, d)], dim=1)     # drop slot
    rows = torch.arange(n_groups, device=y.device)[:, None, None]
    picked = y[rows, dst]                                       # (G, g, k, D)
    return (picked * gates[..., None].to(y.dtype)).sum(dim=2)


def load_balance_loss(params, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · p_e, with f_e the share
    of tokens whose top choice is e (ties to the lower index)."""
    d = x.shape[-1]
    probs = torch.softmax(_router_logits(params, x.reshape(-1, d)), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, spec.num_experts).to(probs.dtype).mean(dim=0)
    return spec.num_experts * torch.sum(frac * probs.mean(dim=0))


def moe_ref(params, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Dense all-experts reference (the tests' oracle): every expert on
    every token, combined with the full top-k gate, no capacity drops.
    Equals ``moe_block`` only where no choice overflows."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gate_vals, expert_ids = moe_topk_ref(_router_logits(params, xf),
                                         spec.experts_per_token)
    gates = torch.zeros(xf.shape[0], spec.num_experts, dtype=gate_vals.dtype,
                        device=x.device)
    gates.scatter_(1, expert_ids.long(), gate_vals)
    h = torch.einsum("td,edf->tef", xf, params["w_gate"])
    u = torch.einsum("td,edf->tef", xf, params["w_up"])
    y = torch.einsum("tef,efd->ted", F.silu(h) * u, params["w_down"])
    out = torch.einsum("te,ted->td", gates.to(y.dtype), y)
    return out.reshape(b, s, d).to(x.dtype)
