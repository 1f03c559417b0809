"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The Mistral-7B language backbone: 32L d_model=4096 32H (GQA kv=8) of 128,
d_ff=14336, vocab=32000, RoPE θ = 1e6. The vision tower and projector are
stubs, as in the reference: ``models.frontends.vision_patches`` gives
patch embeddings of shape (B, 2880, d_model) (anyres: 5 tiles × 576),
which the model puts before the token embeddings in one sequence.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision",
    num_patches=2880,        # anyres: 5 tiles × (24×24)
    rope_theta=1000000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="llava-next-mistral-7b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_patches=16,
))
