"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (kimi), DeepSeek-V3-style MoE
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
First layer dense (DeepSeek-style), remaining layers MoE with per-expert
d_ff=1408. ``long_500k`` skipped (full attention).
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="dense",          # the reference's bracket ([dense] with MoE spec)
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_every=1,
    first_dense_layers=1,
    rope_theta=50000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="moonshot-v1-16b-a3b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=0,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    first_dense_layers=1,
    moe_group_size=64,
))
