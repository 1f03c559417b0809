"""Plain reference of a jamba stack's next-token loss (arXiv:2403.19887:
mamba mixers, SwiGLU and top-k mixture-of-experts channel mixers,
RMSNorm, an unembedding tied to the embedding) and of the NetES consensus
update over P members, written from the papers in plain PyTorch.

It imports nothing of the program. The weights are read by name from one
nested dict (the layout ``runners/consensus_lm.py`` makes); ``get(path)``
hands each leaf over as it is needed, so a perturbed member's weights are
made one leaf at a time and never whole.

``precision``: ``"f64"`` (the reference) or ``"tf32"`` (the control:
float32 with every matrix product's operands rounded to TF32).

What this stack computes, and where it departs from the published jamba:
no RMSNorm on Δ, B and C inside the mamba mixer; the tied unembedding;
and the experts' capacity: tokens are routed in groups of ``group``
tokens, and an expert takes at most C = ⌊group·k·cf/E⌋ of a group's
(token, choice) pairs, in token order, a pair over capacity adding
nothing (GShard's dispatch). These are the port's choices; the reference
follows them so that the two compute one function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .netes_ref import centered_ranks, tf32


def _dtype(precision):
    return torch.float64 if precision == "f64" else torch.float32


def mm(a, b, precision):
    if precision == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    return torch.matmul(a, b)


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale


def _scan(decay, drive, h0):
    """h_t = decay_t ⊙ h_{t−1} + drive_t over axis 0 from h0, by doubling
    (Hillis–Steele): (L, ...) → (L, ...)."""
    a, h = decay.clone(), drive.clone()
    h[0] += a[0] * h0
    off = 1
    while off < h.shape[0]:
        h[off:] = h[off:] + a[off:] * h[:-off]
        a[off:] = a[off:] * a[:-off]
        off *= 2
    return h


def mamba(get, pre, x, cfg, precision, chunk=256):
    """The selective SSM mixer on one sequence x (S, d):

        h_t = exp(Δ_t A) ⊙ h_{t−1} + Δ_t B_t x_t,  y_t = C_t · h_t + D ⊙ x_t

    after a causal depthwise conv and SiLU, gated by SiLU(z), with
    Δ = softplus(x W_x[:, :r] W_dt + b_dt), A = −exp(A_log)."""
    s = x.shape[0]
    r, ds = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
    xin = mm(x, get(pre + ("in_x",)), precision)
    z = mm(x, get(pre + ("in_z",)), precision)
    w = get(pre + ("conv_w",))
    k = w.shape[0]
    xp = F.pad(xin, (0, 0, k - 1, 0))
    conv = sum(xp[i:i + s] * w[i] for i in range(k))
    xc = F.silu(conv + get(pre + ("conv_b",)))
    del xin, xp, conv
    proj = mm(xc, get(pre + ("x_proj",)), precision)
    dt = F.softplus(mm(proj[:, :r].contiguous(), get(pre + ("dt_proj",)),
                       precision) + get(pre + ("dt_bias",)), threshold=1e9)
    b, c = proj[:, r:r + ds], proj[:, r + ds:]
    a = -torch.exp(get(pre + ("A_log",)))                  # (di, ds)
    h = torch.zeros_like(a)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        decay = torch.exp(dt[sl, :, None] * a)
        drive = dt[sl, :, None] * b[sl, None, :] * xc[sl, :, None]
        hs = _scan(decay, drive, h)
        del decay, drive
        ys.append((hs * c[sl, None, :]).sum(-1))
        h = hs[-1].clone()
        del hs
    y = torch.cat(ys) + get(pre + ("D",)) * xc
    return mm(y * F.silu(z), get(pre + ("out_proj",)), precision)


def swiglu(wg, wu, wd, x, precision):
    return mm(F.silu(mm(x, wg, precision)) * mm(x, wu, precision), wd,
              precision)


def moe(get, pre, x, cfg, precision):
    """Top-k of E experts a token (softmax over all E, the k largest with
    ties to the lower index, renormalised over the k), with capacity
    C per group of ``moe_group_size`` tokens."""
    s, _ = x.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    g = min(cfg["moe_group_size"], s)
    cap = max(int(g * k * cfg["moe_capacity_factor"] / e), k)
    probs = torch.softmax(mm(x, get(pre + ("router",)), precision), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    gates = vals / vals.sum(dim=-1, keepdim=True)
    kept = torch.zeros_like(ids, dtype=torch.bool)
    for g0 in range(0, s, g):
        flat = ids[g0:g0 + g].reshape(-1)          # (token, choice) order
        order = torch.sort(flat, stable=True).indices
        pos = torch.empty_like(flat)
        counts = torch.bincount(flat, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        pos[order] = torch.arange(flat.numel(), device=x.device) \
            - starts[flat[order]]
        kept[g0:g0 + g] = (pos < cap).reshape(-1, k)
    out = torch.zeros_like(x)
    wg, wu, wd = (get(pre + (n,)) for n in ("w_gate", "w_up", "w_down"))
    for ex in range(e):
        tok, choice = torch.nonzero((ids == ex) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(wg[ex], wu[ex], wd[ex], x[tok], precision)
        out.index_add_(0, tok, gates[tok, choice, None] * y)
    return out


def loss(get, tokens, cfg, precision, xent_chunk=512):
    """Mean next-token cross-entropy of one sequence (S,) of token ids
    (the last position, which has no next token, left out)."""
    dt = _dtype(precision)
    embed = get(("embed",))
    x = embed[tokens.long()].to(dt)
    for i in range(cfg["num_hidden_layers"]):
        pre = ("layers", i)
        h = rmsnorm(x, get(pre + ("norm1", "scale")))
        x = x + mamba(get, pre + ("mamba",), h, cfg, precision)
        h = rmsnorm(x, get(pre + ("norm2", "scale")))
        if (i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
                and cfg["num_experts"] > 1):
            x = x + moe(get, pre + ("moe",), h, cfg, precision)
        else:
            f = pre + ("ffn",)
            x = x + swiglu(get(f + ("w_gate",)), get(f + ("w_up",)),
                           get(f + ("w_down",)), h, precision)
    x = rmsnorm(x, get(("final_norm", "scale")))
    s = x.shape[0]
    nxt = tokens[1:].long()
    total = torch.zeros((), dtype=dt, device=x.device)
    for c0 in range(0, s - 1, xent_chunk):
        c1 = min(c0 + xent_chunk, s - 1)
        logits = mm(x[c0:c1], embed.T, precision)
        total = total + (torch.logsumexp(logits, dim=-1)
                         - logits.gather(1, nxt[c0:c1, None])[:, 0]).sum()
    return total / (s - 1)


def consensus_coefficients(losses_pos, losses_neg, adj):
    """c_m = (s⁺_m − s⁻_m) · deg_m / P, s the centered ranks of the 2P
    rewards (negated losses), deg_m the column sums of the adjacency; and
    the index of the best of the 2P (ties to the first)."""
    p = losses_pos.shape[0]
    raw = -torch.cat([losses_pos, losses_neg])
    shaped = centered_ranks(raw)
    deg = adj.to(raw.dtype).sum(dim=0) / p
    return (shaped[:p] - shaped[p:]) * deg, int(torch.argmax(raw))


def update_leaf(theta, eps_of, coeff, best, beta, cfg):
    """One leaf's consensus update in the leaf's dtype:

        θ' = θ + α/(Pσ) · Σ_m c_m ε_m − wd·θ,

    or, when β < p_b, the best member's θ ± σε_b."""
    p = coeff.shape[0]
    if beta < cfg["p_broadcast"]:
        sign = 1.0 if best < p else -1.0
        return theta + sign * cfg["sigma"] * eps_of(best % p)
    acc = torch.zeros_like(theta)
    for m in range(p):
        acc += coeff[m] * eps_of(m)
    return (theta + (cfg["alpha"] / (p * cfg["sigma"])) * acc
            - cfg["weight_decay"] * theta)

