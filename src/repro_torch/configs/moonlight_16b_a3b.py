"""moonlight-16b-a3b — Moonlight-16B-A3B at its published shape, a
port-only architecture [hf:moonshotai/Moonlight-16B-A3B, config.json,
model_type deepseek_v3].

27L d_model=2048, 16 heads of latent attention (MLA: no query low-rank
path, kv_lora_rank 512, qk 128 nope + 64 rope, v 128, rope_theta 50000),
layer 0 a dense SwiGLU of 11264, layers 1–26 MoE: 64 routed experts of
1408, top-6 by sigmoid(logits) + e_score_correction_bias (noaux_tc with
one group), gates normalised over the 6 and scaled by 2.446, plus 2
shared experts of 1408 on every token; RMSNorm eps 1e-5, vocabulary
163840, the unembedding untied.

The registry's ``moonshot-v1-16b-a3b`` is the reference's bracket for the
same model card (48 layers, plain multi-head attention, softmax routing,
no shared experts, tied embeddings) and stays as the reference has it.
``prefill`` and ``decode_step`` raise: the latent KV cache is not ported.
"""
import dataclasses

from .base import PortConfig, register

CONFIG = register(PortConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    head_dim=192,
    num_experts=64,
    experts_per_token=6,
    moe_every=1,
    first_dense_layers=1,
    attn_kind="mla",
    rope_theta=50000.0,
    tie_embeddings=False,
    source="hf:moonshotai/Moonlight-16B-A3B",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe_d_ff=1408,
    n_shared_experts=2,
    scoring="sigmoid",
    routed_scaling_factor=2.446,
    router_bias_seed=0,
    router_bias_std=0.01,
    norm_eps=1e-5,
))

# the published per-head widths (the flash kernel's 192/128 instance) at
# two heads, a dense layer then two MoE layers of 8 experts, top-3
SMOKE = register(dataclasses.replace(
    CONFIG,
    name="moonlight-16b-a3b-smoke",
    num_layers=3,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    num_experts=8,
    experts_per_token=3,
    moe_group_size=64,
    kv_lora_rank=64,
    moe_d_ff=32,
))
