"""llama4-maverick-400b-a17b [moe] — MoE 128 experts, top-1, on every
other layer [the reference cites hf:meta-llama/Llama-4-Scout-17B-16E;
Maverick's card: meta-llama/Llama-4-Maverick-17B-128E].

48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=8192 vocab=202048.
MoE on the even layers (``moe_every=2``), SwiGLU on the odd ones; the
attention is scout's: chunked-local (chunk 8192) with a global layer every
4th (offset 3), qk-norm, one RoPE θ = 5e5 on every layer, no shared
expert. One MoE layer's experts are 64.4 GB in float32. The smoke model:
a chunked layer (chunk 64) with an MoE of 4 experts, top-1, then a global
layer with SwiGLU.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
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
    name="llama4-maverick-400b-a17b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    experts_per_token=1,
    moe_every=2,
    chunk_size=64,
    global_every=2,
    global_offset=1,
    moe_group_size=64,
))
