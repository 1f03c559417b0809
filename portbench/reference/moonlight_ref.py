"""Plain reference of Moonlight-16B-A3B's next-token loss (a DeepSeek-V3
stack: latent attention (MLA), a dense SwiGLU first layer, then layers of
64 sigmoid-routed experts plus shared experts, RMSNorm, an untied
unembedding), written from the published description in plain PyTorch:
https://huggingface.co/moonshotai/Moonlight-16B-A3B (config.json and its
DeepSeek-V3 modeling code).

It imports nothing of the program. The weights are read by name from one
nested dict (the layout ``runners/consensus_moonlight.py`` makes) through
``get(path)``, one leaf at a time. The consensus update's coefficients
and leaf rule are ``jamba_ref``'s, as are its matrix product (``mm``:
TF32-rounded operands in the control), RMSNorm and SwiGLU.

``precision``: ``"f64"`` (the reference), ``"f32"`` or ``"tf32"`` (the
control: float32 with every matrix product's operands rounded to TF32).

``loss`` routes the tokens through ``Routes``: by its own top-k, or by
the expert choices another computation made (a program's), held to the
reference's own scores by ``Routes.slack``. A token whose k-th and
(k+1)-th scores lie within float32's rounding of each other may go to
either expert, and where experts are full the drops move with it, so a
loss routed by its own choices can differ from the program's by far more
than rounding; routed by the program's, it differs by rounding alone,
and the slack says how far each choice lay from the reference's own.

The layer, for x (S, D), H heads, widths nope / rope / v and latent r:

    h = RMSNorm(x);  q = h W_q → H × (nope + rope)
    c, k_pe = h W_kv_a → (r, rope);  c = RMSNorm(c)
    k_nope, v = c W_kv_b → H × (nope + v)
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)          (k_pe shared by the heads)
    x = x + W_o · softmax_causal(q·k / √(nope + rope)) v
    h = RMSNorm(x);  x = x + SwiGLU_dense(h)                 (layer 0)
                     x = x + Σ_top-k g_e SwiGLU_e(h) + SwiGLU_shared(h)

with s = sigmoid(h W_router), the experts the top k of s + b
(``e_score_correction_bias`` b, ties to the lower index), g = s / (Σ s +
1e-20) · routed_scaling_factor over the k chosen. Every RMSNorm takes
``rms_norm_eps``.

Departures from the published model, the port's choices, which this
reference follows so that the two compute one function: RoPE rotates the
two halves of the rope columns (``x1 cos − x2 sin, x1 sin + x2 cos``),
where the published code rotates interleaved pairs (a fixed permutation
of the rope columns of W_q and W_kv_a, the same for q and k); the experts'
capacity: tokens are routed in groups of ``moe_group_size`` tokens, and an
expert takes at most C = ⌊group·k·cf/E⌋ of a group's (token, choice)
pairs, in (token, choice) order, a pair over capacity adding nothing
(GShard's dispatch); b is drawn, N(0, std²) from the stated seed, held
fixed (the published rule that moves it belongs to gradient training).
"""
from __future__ import annotations

import math

import torch

from .jamba_ref import (consensus_coefficients, mm, rmsnorm,  # noqa: F401
                        swiglu, update_leaf)


def _dtype(precision):
    return torch.float64 if precision == "f64" else torch.float32


def router_bias(cfg, dtype, device) -> torch.Tensor:
    """b (E,): N(0, std²) from the stated seed on the CPU, in float32 (as
    the program holds it), then in ``dtype`` on ``device``."""
    spec = cfg["assumed"]["e_score_correction_bias"]
    g = torch.Generator().manual_seed(spec["seed"])
    b = torch.randn(cfg["n_routed_experts"], generator=g,
                    dtype=torch.float64) * spec["std"]
    return b.to(torch.float32).to(device=device, dtype=dtype)


class Routes:
    """The expert choices of one loss, a MoE layer at a time in layer
    order. ``Routes()`` routes by the reference's own top-k; ``Routes(ids)``
    by ``ids``, one (S, k) tensor of expert ids a MoE layer (another
    computation's choices, in its order of choice), and ``slack`` is the
    most by which any of them falls short of the reference's top-k: over
    the tokens, the largest score left out less the smallest chosen, or 0
    (the scores those that select, sigmoid plus bias). A layer's ids that
    are not k distinct experts of each token, or a layer missing, read
    ``MALFORMED`` and are routed by the reference's own. ``taken`` keeps
    the ids each layer was routed by (int16, on the CPU)."""
    MALFORMED = 2.0          # over any shortfall: scores lie in (0, 1) + b

    def __init__(self, ids=None):
        self.given = None if ids is None else list(ids)
        self.taken = []
        self.slack = 0.0

    def route(self, sel, k):
        own = torch.sort(sel, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        ids = own
        if self.given is not None:
            short = self.MALFORMED
            if len(self.taken) < len(self.given):
                ids = self.given[len(self.taken)].to(sel.device).long()
                short = _shortfall(sel, ids, k)
            if short == self.MALFORMED:
                ids = own
            self.slack = max(self.slack, short)
        self.taken.append(ids.to("cpu", torch.int16))
        return ids


def _shortfall(sel, ids, k) -> float:
    t, e = sel.shape
    if ids.shape != (t, k) or ids.min() < 0 or ids.max() >= e:
        return Routes.MALFORMED
    chosen = torch.zeros_like(sel, dtype=torch.bool).scatter_(1, ids, True)
    if (chosen.sum(dim=1) != k).any():
        return Routes.MALFORMED
    left_out = sel.masked_fill(chosen, -math.inf).max(dim=1).values
    return float((left_out - sel.gather(1, ids).min(dim=1).values)
                 .clamp(min=0).max())


def rope(x, theta):
    """The split-half rotation of x (S, H, r) at positions 0 … S−1, the
    angles in x's dtype."""
    s, r = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, r, 2, dtype=x.dtype,
                                         device=x.device) / r)
    ang = torch.arange(s, dtype=x.dtype, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(get, pre, x, cfg, precision, q_chunk=1024):
    """Causal latent self-attention of one sequence x (S, D)."""
    s = x.shape[0]
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rp, dv, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], \
        cfg["kv_lora_rank"]
    theta = float(cfg["rope_theta"])
    q = mm(x, get(pre + ("wq",)), precision).view(s, h, nope + rp)
    kv_a = mm(x, get(pre + ("wkv_a",)), precision)
    c = rmsnorm(kv_a[:, :r], get(pre + ("kv_norm", "scale")),
                cfg["rms_norm_eps"])
    k_pe = rope(kv_a[:, None, r:], theta).expand(s, h, rp)
    kv = mm(c, get(pre + ("wkv_b",)), precision).view(s, h, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    qh, kh = q.transpose(0, 1), k.transpose(0, 1)          # (H, S, ·)
    vh = kv[..., nope:].transpose(0, 1)
    scale = 1.0 / math.sqrt(nope + rp)
    out = torch.empty((h, s, dv), dtype=x.dtype, device=x.device)
    for q0 in range(0, s, q_chunk):
        q1 = min(s, q0 + q_chunk)
        sc = mm(qh[:, q0:q1], kh[:, :q1].transpose(1, 2), precision) * scale
        ok = (torch.arange(q0, q1, device=x.device)[:, None]
              >= torch.arange(q1, device=x.device)[None, :])
        p = torch.softmax(torch.where(ok, sc, float("-inf")), dim=-1)
        out[:, q0:q1] = mm(p, vh[:, :q1], precision)
        del sc, p
    return mm(out.transpose(0, 1).reshape(s, h * dv), get(pre + ("wo",)),
              precision)


def moe(get, pre, x, cfg, precision, routes=None):
    """The routed experts of one sequence x (S, D): sigmoid routing with
    the fixed bias (module note) through ``routes`` (a ``Routes``; its own
    top-k without one), capacity C per group of ``moe_group_size``
    tokens."""
    s, _ = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    g = min(cfg["moe_group_size"], s)
    cap = max(int(g * k * cfg["moe_capacity_factor"] / e), k)
    logits = mm(x, get(pre + ("router",)), precision)
    scores = torch.sigmoid(logits)
    sel = scores + router_bias(cfg, scores.dtype, x.device)
    ids = (routes or Routes()).route(sel, k)
    vals = scores.gather(1, ids)
    gates = (vals / (vals.sum(dim=-1, keepdim=True) + 1e-20)
             * cfg["routed_scaling_factor"])
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


def _swiglu_at(get, pre, x, precision):
    return swiglu(get(pre + ("w_gate",)), get(pre + ("w_up",)),
                  get(pre + ("w_down",)), x, precision)


def loss(get, tokens, cfg, precision, xent_chunk=512, routes=None):
    """Mean next-token cross-entropy of one sequence (S,) of token ids
    (the last position, which has no next token, left out), the MoE
    layers routed through ``routes`` (a ``Routes``; by their own top-k
    without one)."""
    dt = _dtype(precision)
    eps = cfg["rms_norm_eps"]
    x = get(("embed",))[tokens.long()].to(dt)
    for i in range(cfg["num_hidden_layers"]):
        pre = ("layers", i)
        h = rmsnorm(x, get(pre + ("norm1", "scale")), eps)
        x = x + mla(get, pre + ("mla",), h, cfg, precision)
        h = rmsnorm(x, get(pre + ("norm2", "scale")), eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu_at(get, pre + ("ffn",), h, precision)
        else:
            x = x + (moe(get, pre + ("moe",), h, cfg, precision, routes)
                     + _swiglu_at(get, pre + ("shared",), h, precision))
    x = rmsnorm(x, get(("final_norm", "scale")), eps)
    head = get(("lm_head",))
    s = x.shape[0]
    nxt = tokens[1:].long()
    total = torch.zeros((), dtype=dt, device=x.device)
    for c0 in range(0, s - 1, xent_chunk):
        c1 = min(c0 + xent_chunk, s - 1)
        logits = mm(x[c0:c1], head, precision)
        total = total + (torch.logsumexp(logits, dim=-1)
                         - logits.gather(1, nxt[c0:c1, None])[:, 0]).sum()
    return total / (s - 1)
