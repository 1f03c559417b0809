"""gemma3-4b [dense] — 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt (the reference's citation); 4b card:
google/gemma-3-4b-pt].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
sliding window 1024 on local layers, global (full) every 6th layer
(offset 5: layers 5, 11, …, 29), qk-norm, one RoPE θ = 1e6 for every
layer as in the reference. The smoke model alternates sliding (window 64)
and global layers.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    attn_kind="sliding",
    sliding_window=1024,
    global_every=6,
    global_offset=5,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:google/gemma-3-1b-pt",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="gemma3-4b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    sliding_window=64,
    global_every=2,
    global_offset=1,
))
