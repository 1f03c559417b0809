"""Architecture configs: the port's own copy of ``repro/configs/base.py``.

``ModelConfig`` fully determines a model; the per-layer layout comes from
the family knobs (``layer_specs``). The dataclasses and the parameter count
are the reference's, field for field, so a config compares equal to its
reference. The port's registry holds every architecture of the
reference's but the NetES policy ``paper-mlp``, for which asking raises
``NotImplementedError`` naming where the port has it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}

# Architectures of the reference's registry that the port does not hold,
# and why. The "-smoke" variant of each goes with it.
UNPORTED = {
    "paper-mlp": "the NetES policy was ported in slice 1 as "
                 "envs/policy.MLPPolicy, which the port builds without the "
                 "registry",
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence-mixer + a channel-mixer."""
    mixer: str          # attn_full | attn_sliding | attn_chunked | mamba | rwkv
    ffn: str            # swiglu | moe | rwkv_channel | gelu
    window: int = 0     # sliding/chunked window size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 ⇒ d_model // num_heads
    source: str = ""                # citation (paper/model card)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # MoE replaces FFN every k-th layer
    moe_offset: int = 0             # first MoE layer index within period
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512

    # --- ffn ---
    ffn_kind: str = "swiglu"        # swiglu | gelu (non-MoE layers)
    first_dense_layers: int = 0     # deepseek-style: first k layers dense

    # --- attention pattern ---
    attn_kind: str = "full"         # default mixer for attention layers
    use_rope: bool = True
    sliding_window: int = 0
    global_every: int = 0           # every k-th layer is full/global attn
    global_offset: int = 0
    chunk_size: int = 0             # llama4 chunked-local attention
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # --- hybrid/ssm ---
    attn_every: int = 0             # jamba: 1 attn per k layers (0 ⇒ all attn)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv: bool = False              # rwkv6 mixer on all layers

    # --- enc-dec / frontends ---
    encoder_layers: int = 0         # >0 ⇒ encoder-decoder (whisper)
    encoder_seq: int = 0            # e.g. 1500 audio frames
    frontend: Optional[str] = None  # None | audio | vision
    num_patches: int = 0            # vision tokens per image (llava)
    learned_pos: bool = False       # learned positional embeddings (whisper)
    max_position: int = 0           # for learned_pos tables

    tie_embeddings: bool = True
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # --- paper-technique defaults for this arch ---
    netes_topology: str = "erdos_renyi"
    netes_density: float = 0.5

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Derive the per-layer layout from the pattern knobs."""
        specs = []
        for i in range(self.num_layers):
            # ---- sequence mixer ----
            if self.rwkv:
                mixer, window = "rwkv", 0
            elif self.attn_every and (i % self.attn_every) != self.attn_every - 1:
                mixer, window = "mamba", 0   # jamba: attn on last-in-period
            elif self.global_every:
                if (i % self.global_every) == self.global_offset % self.global_every:
                    mixer, window = "attn_full", 0
                elif self.chunk_size:
                    mixer, window = "attn_chunked", self.chunk_size
                else:
                    mixer, window = "attn_sliding", self.sliding_window
            elif self.attn_kind == "sliding":
                mixer, window = "attn_sliding", self.sliding_window
            elif self.attn_kind == "chunked":
                mixer, window = "attn_chunked", self.chunk_size
            else:
                mixer, window = "attn_full", 0
            # ---- channel mixer ----
            if self.rwkv:
                ffn = "rwkv_channel"
            elif (self.is_moe and i >= self.first_dense_layers
                  and (i % self.moe_every) == self.moe_offset % self.moe_every):
                ffn = "moe"
            else:
                ffn = self.ffn_kind
            specs.append(LayerSpec(mixer=mixer, ffn=ffn, window=window))
        return tuple(specs)

    def count_params(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for spec in self.layer_specs():
            if spec.mixer.startswith("attn"):
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                n += self.num_heads * hd * d
            elif spec.mixer == "mamba":
                di = self.mamba_expand * d
                r = -(-d // 16)
                n += d * 2 * di + self.mamba_d_conv * di
                n += di * (r + 2 * self.mamba_d_state) + r * di
                n += di * self.mamba_d_state + di + di * d
            elif spec.mixer == "rwkv":
                n += 5 * d * d + 2 * (d * max(16, d // 128) * 2)
            if spec.ffn == "swiglu":
                n += 3 * d * self.d_ff
            elif spec.ffn == "gelu":
                n += 2 * d * self.d_ff + self.d_ff + d
            elif spec.ffn == "moe":
                n += d * self.num_experts + 3 * self.num_experts * d * self.d_ff
            elif spec.ffn == "rwkv_channel":
                n += 2 * d * self.d_ff + d * d
            n += 2 * d                                  # norms
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn
            enc = self.encoder_layers * (
                d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d + 3 * d * self.d_ff + 2 * d)
            cross = self.num_layers * (
                d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d + d)
            n += enc + cross
        return n

    def active_params_per_token(self) -> int:
        """Active (per-token) params — for MoE the top-k slice of experts."""
        if not self.is_moe:
            return self.count_params()
        n = self.count_params()
        for spec in self.layer_specs():
            if spec.ffn == "moe":
                n -= 3 * self.num_experts * self.d_ff * self.d_model
                n += 3 * self.experts_per_token * self.d_ff * self.d_model
        return n


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _unported_slice(name: str) -> Optional[str]:
    base = name[:-len("-smoke")] if name.endswith("-smoke") else name
    return UNPORTED.get(base)


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    where = _unported_slice(name)
    if where is not None:
        raise NotImplementedError(
            f"arch {name!r} is not in the port's registry: {where}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def available_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (gemma3_4b, jamba_v01_52b,  # noqa: F401
                   llama4_maverick_400b_a17b, llama4_scout_17b_a16e,
                   llava_next_mistral_7b, mistral_nemo_12b,
                   moonshot_v1_16b_a3b, phi3_medium_14b, rwkv6_7b,
                   whisper_tiny)
