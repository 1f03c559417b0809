"""llama4-scout-17b-a16e [moe] — MoE 16 experts, top-1, on every layer
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=8192 vocab=202048.
Attention: chunked-local (chunk 8192) with a global (full) layer every
4th (offset 3: layers 3, 7, …, 47), qk-norm, one RoPE θ = 5e5 on every
layer as in the reference (the released model has no RoPE on its global
layers), no shared expert. The smoke model alternates a chunked layer
(chunk 64) and a global one, each with an MoE of 4 experts, top-1.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    moe_every=1,
    attn_kind="chunked",
    chunk_size=8192,
    global_every=4,
    global_offset=3,
    qk_norm=True,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="llama4-scout-17b-a16e-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    experts_per_token=1,
    chunk_size=64,
    global_every=2,
    global_offset=1,
    moe_group_size=64,
))
