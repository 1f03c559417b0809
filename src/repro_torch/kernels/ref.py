"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function has its kernel's signature. The two Eq. 3 mixings go through
the topology's own plain contractions, ``weighted_neighbor_sum`` and
``weighted_row_sum``:

    out_j = Σ_i a_ji R̃θ_i θ_i + σ Σ_i a_ji R̃ε_i ε_i − (Σ_i a_ji R̃θ_i) θ_j.

The two wire-form functions widen the int8 codes one gathered row at a
time, with the decode scale folded into the slot weight as the kernel does.

The receiver ≠ sender forms (``*_rs_ref``: R receivers, S senders, the
per-shard contraction of ``distributed.fleet_shard``) go through
``slot_contract`` and ``dense_contract``, which sum slot by slot and source
by source and round each product before it is added: a row's result then
depends on its own slots alone, never on R, S or where the row sits.
``flash_attention_ref`` is naive softmax attention: it materialises every
(query, key) score. ``moe_topk_ref`` is a softmax and a stable sort.
``rwkv6_wkv_ref`` is the WKV-6 recurrence and ``mamba_scan_ref`` the
mamba selective-scan recurrence, each as a loop over the sequence.

The kernel wrappers run them for CPU tensors; on the card, ``chip_smoke.py``
holds each kernel against them. They are no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.topology_repr import (Topology, weighted_neighbor_sum,
                                  weighted_row_sum)


def _eq3(topo: Topology, w_theta, w_eps, theta, eps, sigma: float):
    return (weighted_neighbor_sum(topo, w_theta, theta)
            + sigma * weighted_neighbor_sum(topo, w_eps, eps)
            - weighted_row_sum(topo, w_theta)[:, None] * theta)


def netes_mixing_ref(adj, w_theta, w_eps, theta, eps, *, sigma: float):
    """Eq. 3 over a dense adjacency ``adj (N, N)``."""
    topo = Topology(kind="dense", n=adj.shape[0], deg=adj.sum(dim=1), adj=adj)
    return _eq3(topo, w_theta, w_eps, theta, eps, sigma)


def sparse_mixing_ref(neighbor_idx, neighbor_mask, w_theta, w_eps, theta,
                      eps, *, sigma: float):
    """Eq. 3 over a padded neighbor list ``neighbor_idx, neighbor_mask
    (N, K)``; padded slots carry weight 0."""
    topo = Topology(kind="sparse", n=neighbor_idx.shape[0],
                    deg=neighbor_mask.sum(dim=1), neighbor_idx=neighbor_idx,
                    neighbor_mask=neighbor_mask)
    return _eq3(topo, w_theta, w_eps, theta, eps, sigma)


def folded_weights(neighbor_idx, neighbor_mask, coeff, scale,
                   edge_mask: Optional[torch.Tensor] = None):
    """(N, K) float32 slot weights with the decode scale folded in,
    ``ws = ((m · coeff[idx]) · em) · scale[idx]``, in the reference's order
    (``repro/kernels/netes_fused_mixing.py:_folded_weights``)."""
    idx = neighbor_idx.long()
    w = neighbor_mask * coeff.to(torch.float32)[idx]
    if edge_mask is not None:
        w = w * edge_mask
    return w * scale.reshape(-1)[idx]


def fused_neighbor_sum_ref(neighbor_idx, neighbor_mask, coeff, codes, scale,
                           edge_mask: Optional[torch.Tensor] = None):
    """``out_j = Σ_k ws_jk · codes[idx_jk]`` over the folded weights, in
    slot order: Eq. 3's neighbor contraction of a wire payload. codes
    (N, D) int8, scale (N, 1) float32 → (N, D) float32."""
    ws = folded_weights(neighbor_idx, neighbor_mask, coeff, scale, edge_mask)
    idx = neighbor_idx.long()
    acc = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    for k in range(idx.shape[1]):
        acc = acc + ws[:, k, None] * codes[idx[:, k]].to(torch.float32)
    return acc


def slot_contract(idx, w, values):
    """``(Σ_k w[j,k]·values[idx[j,k]], Σ_k w[j,k])`` in slot order, each
    product rounded before its add. idx (R, K) int, w (R, K), values
    (S, D) → ((R, D), (R,))."""
    acc = torch.zeros((idx.shape[0], values.shape[1]), dtype=values.dtype,
                      device=values.device)
    ws = torch.zeros((idx.shape[0],), dtype=w.dtype, device=w.device)
    idx = idx.long()
    for c in range(idx.shape[1]):
        wc = w[:, c]
        acc = acc + wc[:, None] * values[idx[:, c]]
        ws = ws + wc
    return acc, ws


def dense_contract(adjb, coeff, values):
    """``(Σ_s adjb[:,s]·coeff[s]·values[s], Σ_s adjb[:,s]·coeff[s])`` in
    source order, each weight and product rounded before its add. adjb
    (R, S), coeff (S,), values (S, D) → ((R, D), (R,))."""
    acc = torch.zeros((adjb.shape[0], values.shape[1]), dtype=values.dtype,
                      device=values.device)
    ws = torch.zeros((adjb.shape[0],), dtype=values.dtype,
                     device=values.device)
    for c in range(values.shape[0]):
        wc = adjb[:, c] * coeff[c]
        acc = acc + wc[:, None] * values[c][None, :]
        ws = ws + wc
    return acc, ws


def netes_mixing_rs_ref(adj, w, x, theta):
    """Eq. 3 of R receivers over S senders, dense: ``out_j = Σ_s a_js·w_s·
    x_s − (Σ_s a_js·w_s)·θ_j``. adj (R, S), w (S,), x (S, P) the senders'
    payload, theta (R, P) the receivers' own parameters."""
    mixed, ws = dense_contract(adj, w, x)
    return mixed - ws[:, None] * theta


def sparse_mixing_rs_ref(neighbor_idx, neighbor_mask, w, x, theta):
    """Eq. 3 of R receivers over S senders, from a padded list: ``out_j =
    Σ_k m_jk·w_i·x_i − (Σ_k m_jk·w_i)·θ_j`` with i = idx[j, k] in [0, S).
    neighbor_idx, neighbor_mask (R, K), w (S,), x (S, P), theta (R, P)."""
    mixed, ws = slot_contract(neighbor_idx,
                              neighbor_mask * w[neighbor_idx.long()], x)
    return mixed - ws[:, None] * theta


def fused_neighbor_sum_rs_ref(neighbor_idx, neighbor_mask, w, codes, scale,
                              theta):
    """``sparse_mixing_rs_ref`` with the senders' payload in wire form:
    x = codes · scale decoded (codes (S, D) int8, scale (S, 1)), then the
    same slots in the same order."""
    return sparse_mixing_rs_ref(neighbor_idx, neighbor_mask, w,
                                codes.to(torch.float32) * scale, theta)


def broadcast_select_ref(codes, scale, do_broadcast, thetas):
    """``where(do_broadcast, codes · scale, θ)``: every agent adopts the
    decoded broadcast payload when the flag is set. codes (D,) int8,
    scale (1,) float32, do_broadcast () bool, thetas (N, D)."""
    dec = (codes.to(torch.float32) * scale).to(thetas.dtype)
    return torch.where(do_broadcast, dec[None, :], thetas)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        chunk: int = 0, scale=None):
    """Naive softmax attention with the flash kernel's masks, in the
    reference's op order (``repro/kernels/ref.py:68-90``). q (B, Sq, H, hd);
    k, v (B, Sk, Hkv, hd); query head h reads KV head h // (H / Hkv).
    A row with no valid key gets the mean of v over the Sk keys. Computes
    in float32, or in float64 for float64 inputs (the full forward's
    float64 reference)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale or hd ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qr = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.to(acc), k.to(acc)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    if chunk:
        ok &= (qpos // chunk) == (kpos // chunk)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(acc))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def moe_topk_ref(logits, k: int):
    """Top-k gating of a router: softmax over the E experts, the k largest
    probabilities with ties to the lower index (a stable descending sort,
    as ``lax.top_k`` orders them; ``torch.topk`` makes no such promise),
    then ``vals / max(Σ vals, 1e-9)``. logits (T, E) → (gates (T, k),
    ids (T, k) int32). Computes in float32, or in float64 for a float64
    input (the full forward's float64 reference)."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(acc), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :k], ids[..., :k]
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return vals, ids.to(torch.int32)


def rwkv6_wkv_ref(r, k, v, w, u, s0=None):
    """The RWKV-6 WKV recurrence, one step at a time (the reference's
    ``repro/kernels/ref.py:107``, with an initial state):

        out_t = r_t · (diag(u) · k_tᵀ v_t + S_{t−1})
        S_t   = diag(w_t) · S_{t−1} + k_tᵀ v_t

    r, k, v, w (B, S, H, n); u (H, n); s0 (B, H, n, n), or None for a
    zero state. Returns (out (B, S, H, n), final state (B, H, n, n)),
    computed in float32, or in float64 for a float64 input (the float64
    reference on the card)."""
    acc = torch.promote_types(r.dtype, torch.float32)
    b, s, h, n = r.shape
    r, k, v, w, u = (t.to(acc) for t in (r, k, v, w, u))
    state = (torch.zeros((b, h, n, n), dtype=acc, device=r.device)
             if s0 is None else s0.to(acc))
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, n, n)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                                 u[None, :, :, None] * kv + state))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def mamba_scan_ref(decay, drive, h0=None):
    """The mamba selective-scan recurrence, one step at a time (the
    reference's ``repro/kernels/ref.py:93``, with an initial state):

        h_t = decay_t ⊙ h_{t−1} + drive_t        over axis 1 (time)

    decay, drive (B, S, D, N); h0 (B, D, N), or None for a zero state.
    Returns every h_t, (B, S, D, N), computed in float32, or in float64 for
    a float64 input (the float64 reference on the card)."""
    acc = torch.promote_types(decay.dtype, torch.float32)
    b, s, d, n = decay.shape
    h = (torch.zeros((b, d, n), dtype=acc, device=decay.device)
         if h0 is None else h0.to(acc))
    out = torch.empty((b, s, d, n), dtype=acc, device=decay.device)
    for t in range(s):
        h = decay[:, t].to(acc) * h + drive[:, t].to(acc)
        out[:, t] = h
    return out
