"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].
32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 head_dim is 64 ⇒ 64 WKV heads at d_model=4096. ``long_500k`` runs
(O(1) recurrent state).
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # WKV heads (head_dim 64)
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv=True,
    norm="layernorm",
    source="arXiv:2404.05892",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="rwkv6-7b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=0,
    d_ff=512,
    vocab_size=512,
))
