"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
Pure full attention ⇒ ``long_500k`` skipped (DESIGN.md).
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    source="arXiv:2404.14219",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="phi3-medium-14b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
))
