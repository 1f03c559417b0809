"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Jamba period: 8 layers with 1 attention layer (placed last in each
period, ``attn_every=8``); MoE replaces the FFN every other layer
(``moe_every=2``). Attention layers use a sliding window of 4096.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    attn_kind="sliding",
    sliding_window=4096,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="jamba-v0.1-52b-smoke",
    num_layers=2,           # 1 mamba + 1 attn (attn_every=2)
    attn_every=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=0,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    sliding_window=64,
    moe_group_size=64,
))
