"""The benchmark's own yardstick: one H100's peaks and the operations and
bytes that each measured piece of work needs, counted from its shapes.

The counts are of what the mathematics needs, whatever implements it: a
later implementation that does the work another way (fused, redesigned,
sparse) is held to the same count. Peaks are NVIDIA's data sheet values
for the H100 SXM at its 700 W limit, dense, without sparsity.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 66.9e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def roofline_time(flops: float, nbytes: float) -> tuple:
    """(least seconds, the bound: "flops" or "bytes")."""
    t_ops = flops / PEAK_F32_FLOPS
    t_mem = nbytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_mem else (t_mem, "bytes")


# --------------------------------------------------------------------------
# NetES on a policy population (paper Eq. 3 and the rollout)
# --------------------------------------------------------------------------

def eq3_dense(n: int, d: int) -> tuple:
    """Σ_i a_ji R̃_i (θ_i + σε_i − θ_j) over a dense (N, N) adjacency:
    (flops, bytes). The product is 2·N²·D; θ, ε and the adjacency are read
    once and θ' written once."""
    return 2.0 * n * n * d, F32 * (n * n + 3.0 * n * d)


def eq3_sparse(edges: int, n: int, d: int) -> tuple:
    """The same over a graph's real directed edges E (self-loops
    included; not a padded neighbor list): 2·E·D flops; θ and ε read
    once, θ' written once, and each edge's index and weight read once."""
    return 2.0 * edges * d, F32 * (3.0 * n * d) + 8.0 * edges


def mlp_flops_per_step(dims) -> float:
    """Multiply-adds of one policy forward, as flops (2 per product)."""
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:],
                                           strict=True))


def rollout_flops(n_candidates: int, episode_len: int, dims) -> float:
    """The policy's products over every step of every episode."""
    return n_candidates * episode_len * mlp_flops_per_step(dims)


# --------------------------------------------------------------------------
# a hybrid mamba / MoE language model's loss (jamba)
# --------------------------------------------------------------------------

def lm_loss_dot_flops(cfg: dict, tokens: int) -> float:
    """Dot flops of one forward loss over ``tokens`` tokens of a jamba
    stack cut to ``cfg["num_hidden_layers"]`` mamba layers, with layer i an
    expert layer where i % expert_layer_period == expert_layer_offset:
    each token's products with every weight it passes through, the top-k
    experts of an expert layer (not every expert, and not the capacity's
    empty slots), the router, the SSM's output contraction with C, and the
    unembedding over the whole vocabulary."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    di = cfg["mamba_expand"] * d
    ds, r = cfg["mamba_d_state"], cfg["mamba_dt_rank"]
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    mamba = 2 * d * di + di * (r + 2 * ds) + r * di + di * d + di * ds
    dense_ffn = 3 * d * f
    moe_ffn = d * e + k * 3 * d * f
    per_token = 0
    for i in range(cfg["num_hidden_layers"]):
        moe = (i % cfg["expert_layer_period"]
               == cfg["expert_layer_offset"] and e > 1)
        per_token += mamba + (moe_ffn if moe else dense_ffn)
    per_token += d * cfg["vocab_size"]
    return 2.0 * tokens * per_token


def consensus_step_flops(cfg: dict, population: int, seq_len: int) -> float:
    """The 2P member losses of one consensus step, each over one
    sequence."""
    return 2 * population * lm_loss_dot_flops(cfg, seq_len)


def moe_capacity_slots(cfg: dict, tokens: int) -> float:
    """Expert slots a capacity-factor dispatch fills per expert layer:
    groups · E · C, with C = ⌊g·k·cf / E⌋ (at least k). An implementation
    that runs its experts over every slot, empty ones included, does
    (slots − k·tokens) · 3·d·f more multiply-adds a layer than the top-k
    count above."""
    g = min(cfg["moe_group_size"], tokens)
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    cap = max(int(g * k * cfg["moe_capacity_factor"] / e), k)
    return (tokens // g) * e * cap

