"""The operations and bytes of Moonlight-16B-A3B's consensus step and of
its two new kernel instances, counted from the configuration's shapes
(``roofline.py``'s peaks and rules: what the mathematics needs, whatever
implements it).

A loss over S tokens passes each token through, per layer: the latent
attention's four products (W_q, W_kv_a, W_kv_b, W_o) and its causal core
(q·k at nope + rope, p·v at v: H·(nope + rope + v)·(S + 1)/2 multiply-adds
a token on average), then the dense SwiGLU (layer 0), or the router, the
top-k routed experts (not every expert, and not the capacity's empty
slots) and the shared experts; then the unembedding over the whole
vocabulary.
"""
from __future__ import annotations

from portbench.roofline import F32


def _mla_macs(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    return (d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v)
            + h * v * d)


def loss_dot_flops(cfg: dict, tokens: int) -> float:
    """Dot flops of one forward loss over one sequence of ``tokens``."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    fe, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    k, ns = cfg["num_experts_per_tok"], cfg["n_shared_experts"]
    h = cfg["num_attention_heads"]
    width = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
             + cfg["v_head_dim"])
    core = h * width * (tokens + 1) / 2.0
    per_token = 0.0
    for i in range(cfg["num_hidden_layers"]):
        per_token += _mla_macs(cfg) + core
        if i < cfg["first_k_dense_replace"]:
            per_token += 3 * d * f
        else:
            per_token += d * e + k * 3 * d * fe + 3 * d * ns * fe
    per_token += d * cfg["vocab_size"]
    return 2.0 * tokens * per_token


def step_flops(cfg: dict, population: int, seq_len: int) -> float:
    """The 2P member losses of one consensus step, each over one
    sequence."""
    return 2 * population * loss_dot_flops(cfg, seq_len)


def flash_mla(cfg: dict, seq_len: int) -> tuple:
    """(flops, bytes) of one causal latent-attention core over one
    sequence: 2·H·(dk + dv)·S(S+1)/2 flops (the causal half, diagonal
    included); q and k (dk wide) and v read once, the output (dv wide)
    written once."""
    h = cfg["num_attention_heads"]
    dk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    s = seq_len
    return (2.0 * h * (dk + dv) * s * (s + 1) / 2.0,
            F32 * s * h * (2 * dk + 2 * dv))


def router_sigmoid(cfg: dict, tokens: int) -> tuple:
    """(flops, bytes) of one sigmoid router call over ``tokens``: no dot
    flops; the logits (T, E) and the bias read once, the gates and the
    ids (T, k) written once."""
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    return 0.0, F32 * (tokens * e + e + 2 * tokens * k)


def calls_per_step(cfg: dict, population: int) -> dict:
    """Launches of each instance a consensus step makes: one a layer
    (flash) or a MoE layer (router) of each of the 2P member losses."""
    n = 2 * population
    layers = cfg["num_hidden_layers"]
    return {"flash_mla": n * layers,
            "router_sigmoid": n * (layers - cfg["first_k_dense_replace"])}
