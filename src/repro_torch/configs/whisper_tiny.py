"""whisper-tiny [audio] — encoder-decoder with a conv frontend (a stub)
[arXiv:2212.04356]. 4 decoder layers and 4 encoder layers, d_model=384,
6 heads (kv=6) of 64, d_ff=1536, vocab=51865.

The mel-spectrogram and conv feature extractor are stubs, as in the
reference: ``models.frontends.audio_frames`` gives frame embeddings of
shape (B, 1500, d_model). Pre-LN blocks with GELU MLPs, learned positions
(no RoPE) and LayerNorm. The decoder's position table holds 32768 rows,
past the model card's native 448, as the reference extends it.
"""
import dataclasses

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    ffn_kind="gelu",
    norm="layernorm",
    use_rope=False,
    learned_pos=True,
    max_position=32768,
    frontend="audio",
    tie_embeddings=True,
    source="arXiv:2212.04356",
))

SMOKE = register(dataclasses.replace(
    CONFIG,
    name="whisper-tiny-smoke",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=64,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=0,
    d_ff=256,
    vocab_size=512,
    max_position=1024,
))
