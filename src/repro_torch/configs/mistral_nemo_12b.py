"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128,
rope_theta=1M. Pure full attention ⇒ ``long_500k`` skipped (DESIGN.md).
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="mistral-nemo-12b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
))
