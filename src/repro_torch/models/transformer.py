"""Model assembly: the port of ``repro/models/transformer.py``, the
attention, mamba (hybrid) and rwkv6 decoder branches.

A config-driven decoder: the per-layer ``LayerSpec`` picks the sequence
mixer (full / sliding / chunked attention, mamba, or rwkv) and the channel
mixer (swiglu / gelu / moe / rwkv_channel; ``first_dense_layers`` and
jamba's interleave of mamba, attention and MoE layers reach it through
``cfg.layer_specs()``). ``prefill`` and ``decode_step`` run the flash
kernel (prefill), the MoE router, the mamba scan and the WKV recurrence
through their kernels, and so does ``loss_fn`` (the NetES reward) on
float32 parameters, without a cache; the full ``forward`` runs their plain
versions (mamba: the associative scan, chunked past 1024 tokens; rwkv: the
chunked form), so that in float64 it is the float64 reference.
Parameters are nested dicts of tensors with the layers as a plain list
(the reference stacks identical layers for ``lax.scan``;
``convert.lm_params_from_reference`` unstacks them). The branches of the
reference that the port does not have yet raise ``NotImplementedError``
naming their slice (ROADMAP.md, queue 1).

API:
  init_params(cfg, seed, dtype, device)           -> params
  forward(params, cfg, batch)                     -> logits (B, S, V)
  loss_fn(params, cfg, batch, xent_chunk)         -> mean next-token xent
  init_cache(cfg, batch, max_len, dtype, device)  -> decode cache
  prefill(params, cfg, batch, cache)              -> (logits (B, V), cache)
  decode_step(params, cfg, token, cache, pos)     -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from .._device import resolve_device
from ..configs.base import LayerSpec, ModelConfig
from ..kernels.moe_router import moe_topk
from ..kernels.ref import moe_topk_ref
from . import attention, layers, mamba, moe, rwkv6

_FRONTENDS = "slice 6f (the vision and audio frontends)"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice of the port that
    brings any part of ``cfg`` this port cannot run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder stack comes with {_FRONTENDS}")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with {_FRONTENDS}")
    if cfg.learned_pos:
        raise NotImplementedError(
            f"{cfg.name}: learned positions come with {_FRONTENDS}")
    if not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: untied embeddings (no architecture of the "
            "registry has them)")


# ---------------------------------------------------------------------------
# spec builders
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig, lspec: LayerSpec) -> attention.AttnSpec:
    kind = {"attn_full": "full", "attn_sliding": "sliding",
            "attn_chunked": "chunked"}[lspec.mixer]
    return attention.AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        kind=kind,
        window=lspec.window,
        rope=cfg.use_rope,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
    )


def mamba_spec(cfg: ModelConfig) -> mamba.MambaSpec:
    return mamba.MambaSpec(d_model=cfg.d_model, d_state=cfg.mamba_d_state,
                           d_conv=cfg.mamba_d_conv, expand=cfg.mamba_expand)


def rwkv_spec(cfg: ModelConfig) -> rwkv6.RWKV6Spec:
    return rwkv6.RWKV6Spec(d_model=cfg.d_model, num_heads=cfg.num_heads)


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(num_experts=cfg.num_experts,
                       experts_per_token=cfg.experts_per_token,
                       d_model=cfg.d_model, d_ff=cfg.d_ff,
                       capacity_factor=cfg.moe_capacity_factor,
                       group_size=cfg.moe_group_size)


def _norm_init(cfg: ModelConfig, d: int, dtype, device):
    return (layers.layernorm_init(d, dtype, device) if cfg.norm == "layernorm"
            else layers.rmsnorm_init(d, dtype, device))


def stack_plan(cfg: ModelConfig):
    """(head, period, n_rep, tail): the reference's layer stacking (layers
    [0, head) unrolled, ``n_rep`` repetitions of a ``period``-layer body
    stacked for ``lax.scan``, then ``tail`` layers unrolled). The port runs
    the layers as a list; this tells ``convert`` how the reference's
    parameters are laid out."""
    specs = cfg.layer_specs()
    length = len(specs)
    best = (0, length, 1, 0)                       # fallback: all unrolled
    for head in range(0, min(length, 3)):
        for period in range(1, length - head + 1):
            if all(specs[i] == specs[head + (i - head) % period]
                   for i in range(head, length)):
                n_rep = (length - head) // period
                tail = (length - head) % period
                if n_rep >= 4 and n_rep > best[2]:
                    best = (head, period, n_rep, tail)
                break                               # smallest period found
    return best


def _norm(cfg: ModelConfig, p, x):
    return (layers.layernorm(p, x) if cfg.norm == "layernorm"
            else layers.rmsnorm(p, x))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, lspec: LayerSpec,
                dtype) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, cfg.d_model, dtype, dev),
                         "norm2": _norm_init(cfg, cfg.d_model, dtype, dev)}
    if lspec.mixer == "rwkv":
        p["rwkv"] = rwkv6.rwkv6_init(gen, rwkv_spec(cfg), dtype)
    elif lspec.mixer == "mamba":
        p["mamba"] = mamba.mamba_init(gen, mamba_spec(cfg), dtype)
    else:
        p["attn"] = attention.attn_init(gen, cfg.d_model,
                                        attn_spec(cfg, lspec), dtype)
    if lspec.ffn == "swiglu":
        p["ffn"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif lspec.ffn == "gelu":
        p["ffn"] = layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif lspec.ffn == "moe":
        p["moe"] = moe.moe_init(gen, moe_spec(cfg), dtype)
    elif lspec.ffn == "rwkv_channel":
        p["ffn"] = rwkv6.rwkv6_channel_init(gen, cfg.d_model, cfg.d_ff, dtype)
    else:
        raise ValueError(lspec.ffn)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's statistics, drawn on ``device``
    from a generator seeded with ``seed``."""
    check_ported(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": _norm_init(cfg, cfg.d_model, dtype, gen.device),
    }
    params["layers"] = [_layer_init(gen, cfg, ls, dtype)
                        for ls in cfg.layer_specs()]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, lspec: LayerSpec, h, topk=moe_topk,
         x_prev=None):
    """The channel mixer; ``topk`` is the MoE router's top-k, ``x_prev``
    the rwkv channel mix's token before ``h``."""
    if lspec.ffn == "swiglu":
        return layers.swiglu(p["ffn"], h)
    if lspec.ffn == "gelu":
        return layers.gelu_mlp(p["ffn"], h)
    if lspec.ffn == "moe":
        return moe.moe_block(p["moe"], moe_spec(cfg), h, topk=topk)
    if lspec.ffn == "rwkv_channel":
        return rwkv6.rwkv6_channel(p["ffn"], h, x_prev)
    raise ValueError(lspec.ffn)


def _layer_forward(p, cfg: ModelConfig, lspec: LayerSpec, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, p["norm1"], x)
    if lspec.mixer == "rwkv":
        x = x + rwkv6.rwkv6_block(p["rwkv"], rwkv_spec(cfg), h)
    elif lspec.mixer == "mamba":
        x = x + mamba.mamba_block(p["mamba"], mamba_spec(cfg), h)
    else:
        x = x + attention.attention_block(p["attn"], attn_spec(cfg, lspec),
                                          h, positions)
    h = _norm(cfg, p["norm2"], x)
    return x + _ffn(p, cfg, lspec, h, topk=moe_topk_ref)


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Token embedding. Returns (x (B, S, D), positions (S,))."""
    check_ported(cfg)
    extra = sorted(set(batch) - {"tokens", "labels"})
    if extra:
        raise NotImplementedError(f"batch inputs {extra} come with "
                                  f"{_FRONTENDS}")
    tokens = batch["tokens"]
    x = params["embed"][tokens]                       # (B, S, D)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _backbone(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Embed + all layers + final norm. Returns x (B, S, D)."""
    x, positions = embed_inputs(params, cfg, batch)
    for p, ls in zip(params["layers"], cfg.layer_specs(), strict=True):
        x = _layer_forward(p, cfg, ls, x, positions)
    return _norm(cfg, params["final_norm"], x)


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Tied embeddings: x @ embedᵀ."""
    return torch.einsum("bsd,vd->bsv", x, params["embed"])


def forward(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns logits (B, S, V). Plain PyTorch throughout (no kernel: the
    attention and the MoE router take their plain versions, the mamba
    mixer the associative scan, the rwkv time mix the chunked form), in
    the parameters' dtype: in float64 it is the float64 reference."""
    return unembed(params, cfg, _backbone(params, cfg, batch))


def _kernel_layer(p, cfg: ModelConfig, lspec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """``_layer_forward`` through the kernels, as prefill runs it, with no
    decode cache: attention through the flash kernel, the MoE router
    through its kernel; mamba and rwkv through ``_prefill_layer`` from a
    zero state (their state is a few rows; the discarded cache costs
    nothing like attention's KV)."""
    if lspec.mixer in ("mamba", "rwkv"):
        cache = _layer_cache(cfg, lspec, x.shape[0], 0, x.dtype, x.device)
        return _prefill_layer(p, cfg, lspec, x, cache, positions)[0]
    h = _norm(cfg, p["norm1"], x)
    x = x + attention.kernel_attention(p["attn"], attn_spec(cfg, lspec), h,
                                       positions)
    h = _norm(cfg, p["norm2"], x)
    return x + _ffn(p, cfg, lspec, h)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            xent_chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy (a 0-d tensor on the parameters'
    device), the unembedding and cross-entropy taken in sequence chunks
    of ``xent_chunk`` so that the (B, S, V) logits are never whole (at
    gemma3-4b's vocabulary a 2048-token row of them is 2.1 GB). The last
    position, which has no next token, is masked out; a sequence that is
    not a multiple of the chunk, or not longer than it, is one chunk, as
    in the reference.

    float32 parameters run the layers as ``prefill`` does, through the
    kernels' wrappers (on the card the flash, router, scan and WKV
    kernels; on the CPU their plain versions). float64 parameters run the
    plain ``forward``'s layers: the float64 yardstick of the kernel path.
    Any other dtype raises. No host sync."""
    dtype = params["embed"].dtype
    if dtype == torch.float64:
        x = _backbone(params, cfg, batch)
    elif dtype == torch.float32:
        x, positions = embed_inputs(params, cfg, batch)
        for p, ls in zip(params["layers"], cfg.layer_specs(), strict=True):
            x = _kernel_layer(p, cfg, ls, x, positions)
        x = _norm(cfg, params["final_norm"], x)
    else:
        raise TypeError(f"loss_fn: parameters of {dtype}; it takes float32 "
                        "(the kernel path) or float64 (the plain yardstick)")
    labels = batch["labels"]
    b, s, _ = x.shape
    labels_next = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
    mask = (torch.arange(s, device=x.device) < s - 1).to(
        layers.acc_dtype(x.dtype))
    chunk = s if s % xent_chunk or s <= xent_chunk else xent_chunk
    total = None
    for c0 in range(0, s, chunk):
        per_tok = layers.softmax_cross_entropy(
            unembed(params, cfg, x[:, c0:c0 + chunk]),
            labels_next[:, c0:c0 + chunk])
        part = (per_tok * mask[None, c0:c0 + chunk]).sum()
        total = part if total is None else total + part
    return total / (b * (s - 1))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, ls: LayerSpec, batch: int, max_len: int,
                 dtype, device) -> Dict[str, Any]:
    if ls.mixer == "rwkv":
        return {"rwkv": rwkv6.init_rwkv_cache(batch, rwkv_spec(cfg), dtype,
                                              device),
                "channel_x_prev": torch.zeros((batch, 1, cfg.d_model),
                                              dtype=dtype, device=device)}
    if ls.mixer == "mamba":
        return {"mamba": mamba.init_mamba_cache(batch, mamba_spec(cfg), dtype,
                                                device)}
    return {"kv": attention.init_kv_cache(batch, attn_spec(cfg, ls), max_len,
                                          dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Decode cache: one entry per layer, in layer order."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"layers": [_layer_cache(cfg, ls, batch, max_len, dtype, dev)
                       for ls in cfg.layer_specs()]}


def _decode_layer(p, cfg: ModelConfig, ls: LayerSpec, x, c, pos):
    h = _norm(cfg, p["norm1"], x)
    if ls.mixer == "rwkv":
        mix, state = rwkv6.rwkv6_decode(p["rwkv"], rwkv_spec(cfg), h,
                                        c["rwkv"])
        cnew = {"rwkv": state}
    elif ls.mixer == "mamba":
        mix, state = mamba.mamba_decode(p["mamba"], mamba_spec(cfg), h,
                                        c["mamba"])
        cnew = {"mamba": state}
    else:
        mix, kv = attention.decode_attention(p["attn"], attn_spec(cfg, ls),
                                             h, c["kv"], pos)
        cnew = {"kv": kv}
    x = x + mix
    h = _norm(cfg, p["norm2"], x)
    if ls.ffn == "rwkv_channel":
        f = _ffn(p, cfg, ls, h, x_prev=c["channel_x_prev"])
        cnew["channel_x_prev"] = h
    else:
        f = _ffn(p, cfg, ls, h)
    return x + f, cnew


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                pos: torch.Tensor):
    """One-token decode. token: (B, 1) int; pos: (B,) absolute position.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    x = params["embed"][token]                        # (B,1,D)
    for i, (p, ls) in enumerate(zip(params["layers"], cfg.layer_specs(),
                                    strict=True)):
        x, cache["layers"][i] = _decode_layer(p, cfg, ls, x,
                                              cache["layers"][i], pos)
    x = _norm(cfg, params["final_norm"], x)
    return unembed(params, cfg, x), cache


def _prefill_layer(p, cfg: ModelConfig, ls: LayerSpec, x, c, positions):
    """``_layer_forward`` through the kernels that also fills the layer's
    decode cache (attention's KV slots; mamba's SSM state and conv ring;
    rwkv's WKV state and token shifts)."""
    h = _norm(cfg, p["norm1"], x)
    if ls.mixer == "rwkv":
        mix, state = rwkv6.rwkv6_prefill(p["rwkv"], rwkv_spec(cfg), h,
                                         c["rwkv"])
        cnew = {"rwkv": state}
    elif ls.mixer == "mamba":
        mix, state = mamba.mamba_prefill(p["mamba"], mamba_spec(cfg), h,
                                         c["mamba"])
        cnew = {"mamba": state}
    else:
        mix, kv = attention.prefill_attention(p["attn"], attn_spec(cfg, ls),
                                              h, positions, c["kv"])
        cnew = {"kv": kv}
    x = x + mix
    h = _norm(cfg, p["norm2"], x)
    f = _ffn(p, cfg, ls, h)
    if ls.ffn == "rwkv_channel":
        # as the reference: the channel mix starts from zeros here, not
        # from the cache's channel_x_prev (the same for a zero cache); a
        # copy, since a view of the last row would keep all of h alive
        cnew["channel_x_prev"] = h[:, -1:].clone()
    return x + f, cnew


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict):
    """Prompt prefill: ONE full-sequence forward that writes the decode
    cache directly. Returns ``(last-position logits (B, V), cache)`` — the
    logits that predict the first generated token."""
    x, positions = embed_inputs(params, cfg, batch)
    for i, (p, ls) in enumerate(zip(params["layers"], cfg.layer_specs(),
                                    strict=True)):
        x, cache["layers"][i] = _prefill_layer(p, cfg, ls, x,
                                               cache["layers"][i], positions)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return unembed(params, cfg, x)[:, 0], cache
