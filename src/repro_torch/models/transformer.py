"""Model assembly: the port of ``repro/models/transformer.py``, every
branch of the reference's (an untied unembedding is ``lm_head`` (D, V)),
and the port-only architectures' layers (``configs.base.PortConfig``:
latent attention, ``mla.py``; sigmoid routing with shared experts,
``moe.py``; their norms' epsilon).

A config-driven decoder (and encoder-decoder): the per-layer ``LayerSpec``
picks the sequence mixer (full / sliding / chunked attention, mamba, or
rwkv) and the channel mixer (swiglu / gelu / moe / rwkv_channel;
``first_dense_layers`` and jamba's interleave of mamba, attention and MoE
layers reach it through ``cfg.layer_specs()``). The frontends are stubs
(``frontends.py``): early fusion puts a vision model's patch embeddings
before its token embeddings in one sequence; an encoder-decoder (whisper)
runs a non-causal stack of ``encoder_layers`` over its audio frames once,
and each decoder layer attends the encoder's output through a cross
attention block after its self attention. Learned position tables
(``pos_embed``, ``enc_pos_embed``) take the place of RoPE where
``cfg.learned_pos``.

``prefill`` and ``decode_step`` run the flash kernel (prefill: self,
encoder and cross attention), the MoE router, the mamba scan and the WKV
recurrence through their kernels, and so does ``loss_fn`` (the NetES
reward) on float32 parameters, without a cache; the full ``forward`` runs
their plain versions (mamba: the associative scan, chunked past 1024
tokens; rwkv: the chunked form), so that in float64 it is the float64
reference. Decode's cross attention is plain PyTorch, as in the
reference: it projects the encoder's keys and values again at every step.
Latent attention has no decode cache in the port: ``init_cache``,
``prefill`` and ``decode_step`` raise ``NotImplementedError`` for it.
Parameters are nested dicts of tensors with the decoder layers as a plain
list (the reference stacks identical layers for ``lax.scan``;
``convert.lm_params_from_reference`` unstacks them).

API:
  init_params(cfg, seed, dtype, device)           -> params
  forward(params, cfg, batch)                     -> logits (B, S, V)
  loss_fn(params, cfg, batch, xent_chunk)         -> mean next-token xent
  init_cache(cfg, batch, max_len, dtype, device)  -> decode cache
  prefill(params, cfg, batch, cache)              -> (logits (B, V), cache)
  decode_step(params, cfg, token, cache, pos)     -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from .._device import resolve_device
from ..configs.base import LayerSpec, ModelConfig, PortConfig
from ..distributed.context import maybe_constrain
from ..kernels.moe_router import moe_topk
from ..kernels.ref import moe_topk_ref
from ..launch import op_costs
from . import attention, layers, mamba, mla, moe, rwkv6


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not have: the
    decode cache of latent attention, which would hold the compressed
    latent and the shared rotary key (``init_cache``, ``prefill`` and
    ``decode_step`` call it)."""
    if any(ls.mixer == "mla" for ls in cfg.layer_specs()):
        raise NotImplementedError(
            f"{cfg.name}: the decode cache of latent attention (the "
            "compressed KV latent) is not ported; the loss and the full "
            "forward run")


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
                       d_model=cfg.d_model, d_ff=cfg.expert_d_ff,
                       capacity_factor=cfg.moe_capacity_factor,
                       group_size=cfg.moe_group_size,
                       count_drops=isinstance(cfg, PortConfig))


def moe_router(cfg: ModelConfig, kernel: bool, device):
    """The MoE layers' ``topk(logits, k)``: the hand-written kernel
    (``kernel``) or its plain version, of softmax routing or of a
    ``PortConfig``'s sigmoid routing with its fixed bias."""
    if isinstance(cfg, PortConfig) and cfg.scoring == "sigmoid":
        return moe.sigmoid_router(
            moe.router_bias(cfg.router_bias_seed, cfg.router_bias_std,
                            cfg.num_experts, device),
            cfg.routed_scaling_factor, kernel)
    return moe_topk if kernel else moe_topk_ref


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


def layer_indices(cfg: ModelConfig):
    """The indices of the layers a pass runs, in order: all of them; under
    a folding ``launch.op_costs`` recorder the reference's stacking
    (``stack_plan``): the head, ONE pass of the repeated period counted
    ``n_rep`` times, and the tail (the periods are the same ops at the
    same shapes, as ``hlo_parse`` counts a scanned body by its trip
    count)."""
    length = cfg.num_layers
    rec = op_costs.active()
    if rec is None or not rec.fold:
        yield from range(length)
        return
    head, period, n_rep, tail = stack_plan(cfg)
    yield from range(head)
    with rec.repeat(n_rep):
        yield from range(head, head + period)
    yield from range(head + period * n_rep, length)


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layers.layernorm(p, x)
    return (layers.rmsnorm(p, x, eps=cfg.norm_eps)
            if isinstance(cfg, PortConfig) else layers.rmsnorm(p, x))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, lspec: LayerSpec,
                dtype, cross: bool = False) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, cfg.d_model, dtype, dev),
                         "norm2": _norm_init(cfg, cfg.d_model, dtype, dev)}
    if lspec.mixer == "rwkv":
        p["rwkv"] = rwkv6.rwkv6_init(gen, rwkv_spec(cfg), dtype)
    elif lspec.mixer == "mamba":
        p["mamba"] = mamba.mamba_init(gen, mamba_spec(cfg), dtype)
    elif lspec.mixer == "mla":
        p["mla"] = mla.mla_init(gen, cfg.d_model, mla.mla_spec(cfg), dtype)
    else:
        p["attn"] = attention.attn_init(gen, cfg.d_model,
                                        attn_spec(cfg, lspec), dtype)
    if lspec.ffn == "swiglu":
        p["ffn"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif lspec.ffn == "gelu":
        p["ffn"] = layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif lspec.ffn == "moe":
        p["moe"] = moe.moe_init(gen, moe_spec(cfg), dtype)
        if isinstance(cfg, PortConfig) and cfg.n_shared_experts:
            p["shared"] = layers.swiglu_init(
                gen, cfg.d_model, cfg.n_shared_experts * cfg.moe_d_ff, dtype)
    elif lspec.ffn == "rwkv_channel":
        p["ffn"] = rwkv6.rwkv6_channel_init(gen, cfg.d_model, cfg.d_ff, dtype)
    else:
        raise ValueError(lspec.ffn)
    if cross:
        p["cross"] = attention.attn_init(gen, cfg.d_model, _cross_spec(cfg),
                                         dtype)
        p["norm_cross"] = _norm_init(cfg, cfg.d_model, dtype, dev)
    return p


def _cross_spec(cfg: ModelConfig) -> attention.AttnSpec:
    """The spec of a decoder layer's cross attention (full attention;
    ``causal=False`` at the call)."""
    return attn_spec(cfg, LayerSpec("attn_full", "swiglu"))


def _encoder_spec(cfg: ModelConfig) -> LayerSpec:
    return LayerSpec(mixer="attn_full", ffn=cfg.ffn_kind)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's statistics, drawn on ``device``
    from a generator seeded with ``seed``; on ``device="meta"`` the tree's
    shapes and dtypes alone, with nothing drawn. An untied unembedding is
    ``lm_head`` (D, V), a fan-in truncated normal as the reference's."""
    gen = layers.generator(resolve_device(device), seed)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": _norm_init(cfg, cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)
    if cfg.learned_pos:
        params["pos_embed"] = layers.embed_init(gen, cfg.max_position,
                                                cfg.d_model, dtype)
    cross = cfg.is_encoder_decoder
    params["layers"] = [_layer_init(gen, cfg, ls, dtype, cross=cross)
                        for ls in cfg.layer_specs()]
    if cfg.is_encoder_decoder:
        params["enc_layers"] = [_layer_init(gen, cfg, _encoder_spec(cfg),
                                            dtype)
                                for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = _norm_init(cfg, cfg.d_model, dtype, gen.device)
        if cfg.learned_pos:
            params["enc_pos_embed"] = layers.embed_init(
                gen, cfg.encoder_seq, cfg.d_model, dtype)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, lspec: LayerSpec, h, kernel: bool = True,
         x_prev=None):
    """The channel mixer; the MoE router's top-k through its kernel if
    ``kernel``, else its plain version (``moe_router``); ``x_prev`` the
    rwkv channel mix's token before ``h``."""
    if lspec.ffn == "swiglu":
        return layers.swiglu(p["ffn"], h)
    if lspec.ffn == "gelu":
        return layers.gelu_mlp(p["ffn"], h)
    if lspec.ffn == "moe":
        out = moe.moe_block(p["moe"], moe_spec(cfg), h,
                            topk=moe_router(cfg, kernel, h.device))
        if "shared" in p:
            out = out + moe.shared_experts(p["shared"], h)
        return out
    if lspec.ffn == "rwkv_channel":
        return rwkv6.rwkv6_channel(p["ffn"], h, x_prev)
    raise ValueError(lspec.ffn)


def _full_ffn(p, cfg: ModelConfig, lspec: LayerSpec, h, **kw):
    """``_ffn`` in a full-sequence layer of the loss, as the reference's
    ``_layer_forward``: a dense FFN's input and output take the
    "ffn_input" and "residual" layouts of an active sharding context."""
    if lspec.ffn not in ("swiglu", "gelu"):
        return _ffn(p, cfg, lspec, h, **kw)
    f = _ffn(p, cfg, lspec, maybe_constrain(h, "ffn_input"), **kw)
    return maybe_constrain(f, "residual")


def _cross(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
           enc_out: torch.Tensor, kernel: bool) -> torch.Tensor:
    """A decoder layer's cross attention block (pre-norm, residual) over
    the encoder's output, through the flash kernel or its plain version."""
    block = attention.kernel_attention if kernel else \
        attention.attention_block
    enc_pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    hc = _norm(cfg, p["norm_cross"], x)
    return x + block(p["cross"], _cross_spec(cfg), hc, positions,
                     kv_x=enc_out, kv_positions=enc_pos, causal=False)


def _layer_forward(p, cfg: ModelConfig, lspec: LayerSpec, x: torch.Tensor,
                   positions: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    h = _norm(cfg, p["norm1"], x)
    if lspec.mixer == "rwkv":
        x = x + rwkv6.rwkv6_block(p["rwkv"], rwkv_spec(cfg), h)
    elif lspec.mixer == "mamba":
        x = x + mamba.mamba_block(p["mamba"], mamba_spec(cfg), h)
    elif lspec.mixer == "mla":
        x = x + mla.mla_block(p["mla"], mla.mla_spec(cfg), h, positions,
                              kernel=False)
    else:
        x = x + attention.attention_block(p["attn"], attn_spec(cfg, lspec),
                                          h, positions, causal=causal)
    if enc_out is not None:
        x = _cross(p, cfg, x, positions, enc_out, kernel=False)
    h = _norm(cfg, p["norm2"], x)
    return x + _full_ffn(p, cfg, lspec, h, kernel=False)


def _encode(params, cfg: ModelConfig, frames: torch.Tensor,
            kernel: bool) -> torch.Tensor:
    """The whisper-style encoder over stub frame embeddings (B, T, D): the
    learned positions, a non-causal stack of full-attention layers, then
    ``enc_norm``; through the kernels or their plain versions."""
    t = frames.shape[1]
    x = frames
    if cfg.learned_pos:
        x = x + params["enc_pos_embed"][None, :t]
    pos = torch.arange(t, device=x.device)
    layer = _kernel_layer if kernel else _layer_forward
    for p in params["enc_layers"]:
        x = layer(p, cfg, _encoder_spec(cfg), x, pos, causal=False)
    return _norm(cfg, params["enc_norm"], x)


def check_lengths(cfg: ModelConfig, positions: int,
                  frames: Optional[int] = None) -> None:
    """Raise ``ValueError`` where a learned position table has no row for
    a position: the decoder's ``positions`` (its longest sequence, the
    tokens fed back in decode included) against ``max_position``, and
    ``frames`` against the encoder's ``encoder_seq``. A host check, made
    before the work: on the card an index past a table is a device assert,
    not an error the caller can catch."""
    if not cfg.learned_pos:
        return
    if positions > cfg.max_position:
        raise ValueError(f"{cfg.name}: {positions} positions, the learned "
                         f"table holds {cfg.max_position}")
    if frames is not None and frames > cfg.encoder_seq:
        raise ValueError(f"{cfg.name}: {frames} frames, the encoder's "
                         f"learned table holds {cfg.encoder_seq}")


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 kernel: bool = False):
    """Token embedding with early fusion (a vision model's
    ``patch_embeds`` (B, P, D) before the tokens' embeddings), the learned
    positions, and an encoder-decoder's encoder over ``frames`` (B, T, D),
    run once, through the kernels if ``kernel``. Returns (x (B, S, D),
    positions (S,), the encoder's output (B, T, D) or None)."""
    allowed = {"tokens", "labels"}
    if cfg.frontend == "vision":
        allowed.add("patch_embeds")
    if cfg.is_encoder_decoder:
        allowed.add("frames")
    extra = sorted(set(batch) - allowed)
    if extra:
        raise ValueError(f"{cfg.name} takes no batch inputs {extra}")
    if cfg.is_encoder_decoder and "frames" not in batch:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs 'frames'")
    tokens = batch["tokens"]
    x = params["embed"][tokens]                       # (B, S_text, D)
    if "patch_embeds" in batch:                       # early fusion
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    frames = batch.get("frames")
    check_lengths(cfg, x.shape[1], None if frames is None else
                  frames.shape[1])
    if cfg.learned_pos:
        x = x + params["pos_embed"][None, :x.shape[1]]
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = (None if frames is None else
               _encode(params, cfg, frames.to(x.dtype), kernel))
    return x, positions, enc_out


def _backbone(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Embed + all layers + final norm, plain. Returns x (B, S, D)."""
    x, positions, enc_out = embed_inputs(params, cfg, batch)
    x = maybe_constrain(x, "residual")
    specs = cfg.layer_specs()
    for i in layer_indices(cfg):
        x = maybe_constrain(_layer_forward(params["layers"][i], cfg,
                                           specs[i], x, positions, enc_out),
                            "residual")
    return _norm(cfg, params["final_norm"], x)


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Tied embeddings: x @ embedᵀ; untied: x @ lm_head."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def forward(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns logits (B, S, V), S the patches and the tokens for a vision
    model. Plain PyTorch throughout (no kernel: the attention and the MoE
    router take their plain versions, the mamba mixer the associative
    scan, the rwkv time mix the chunked form), in the parameters' dtype:
    in float64 it is the float64 reference."""
    return unembed(params, cfg, _backbone(params, cfg, batch))


def _kernel_layer(p, cfg: ModelConfig, lspec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor,
                  enc_out: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    """``_layer_forward`` through the kernels, as prefill runs it, with no
    decode cache: attention (self, the encoder's, cross) through the flash
    kernel, the MoE router through its kernel; mamba and rwkv as
    ``_prefill_layer`` mixes them, from a zero state (their state is a few
    rows; the discarded cache costs nothing like attention's KV)."""
    h = _norm(cfg, p["norm1"], x)
    if lspec.mixer in ("mamba", "rwkv"):
        cache = _layer_cache(cfg, lspec, x.shape[0], 0, x.dtype, x.device)
        x = x + _prefill_mix(p, cfg, lspec, h, cache, positions)[0]
    elif lspec.mixer == "mla":
        x = x + mla.mla_block(p["mla"], mla.mla_spec(cfg), h, positions,
                              kernel=True)
    else:
        x = x + attention.kernel_attention(p["attn"], attn_spec(cfg, lspec),
                                           h, positions, causal=causal)
    if enc_out is not None:
        x = _cross(p, cfg, x, positions, enc_out, kernel=True)
    h = _norm(cfg, p["norm2"], x)
    return x + _full_ffn(p, cfg, lspec, h)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            xent_chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy (a 0-d tensor on the parameters'
    device), the unembedding and cross-entropy taken in sequence chunks
    of ``xent_chunk`` so that the (B, S, V) logits are never whole (at
    gemma3-4b's vocabulary a 2048-token row of them is 2.1 GB). The last
    position, which has no next token, is masked out; a sequence that is
    not a multiple of the chunk, or not longer than it, is one chunk, as
    in the reference. A vision model's patch positions are dropped before
    the cross-entropy: ``labels`` are the text tokens.

    float32 parameters run the layers as ``prefill`` does, through the
    kernels' wrappers (on the card the flash, router, scan and WKV
    kernels; on the CPU their plain versions). float64 parameters run the
    plain ``forward``'s layers: the float64 yardstick of the kernel path.
    Any other dtype raises. No host sync."""
    dtype = params["embed"].dtype
    if dtype == torch.float64:
        x = _backbone(params, cfg, batch)
    elif dtype == torch.float32:
        x, positions, enc_out = embed_inputs(params, cfg, batch, kernel=True)
        x = maybe_constrain(x, "residual")
        specs = cfg.layer_specs()
        for i in layer_indices(cfg):
            x = maybe_constrain(_kernel_layer(params["layers"][i], cfg,
                                              specs[i], x, positions,
                                              enc_out), "residual")
        x = _norm(cfg, params["final_norm"], x)
    else:
        raise TypeError(f"loss_fn: parameters of {dtype}; it takes float32 "
                        "(the kernel path) or float64 (the plain yardstick)")
    labels = batch["labels"]
    x = x[:, x.shape[1] - labels.shape[1]:]      # vlm: drop the patches
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
    """Decode cache: one entry per layer, in layer order; an
    encoder-decoder's also holds the encoder's output ``enc_out`` (B,
    encoder_seq, D), which ``prefill`` replaces by the prompt's."""
    check_ported(cfg)
    dev = resolve_device(device)
    cache: Dict[str, Any] = {
        "layers": [_layer_cache(cfg, ls, batch, max_len, dtype, dev)
                   for ls in cfg.layer_specs()]}
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=dtype, device=dev)
    return cache


def _decode_layer(p, cfg: ModelConfig, ls: LayerSpec, x, c, pos, enc_out):
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
    if enc_out is not None:
        x = _cross_decode(p, cfg, x, enc_out)
    h = _norm(cfg, p["norm2"], x)
    if ls.ffn == "rwkv_channel":
        f = _ffn(p, cfg, ls, h, x_prev=c["channel_x_prev"])
        cnew["channel_x_prev"] = h
    else:
        f = _ffn(p, cfg, ls, h)
    return x + f, cnew


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                pos: torch.Tensor):
    """One-token decode. token: (B, 1) int; pos: (B,) absolute position,
    each below ``max_position`` where the positions are learned (the
    caller checks, ``check_lengths``: here the index runs on the device).
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    check_ported(cfg)
    x = params["embed"][token]                        # (B,1,D)
    if cfg.learned_pos:
        x = x + params["pos_embed"][pos][:, None]
    enc_out = cache.get("enc_out")
    specs = cfg.layer_specs()
    for i in layer_indices(cfg):
        x, cache["layers"][i] = _decode_layer(params["layers"][i], cfg,
                                              specs[i], x,
                                              cache["layers"][i], pos,
                                              enc_out)
    x = _norm(cfg, params["final_norm"], x)
    return unembed(params, cfg, x), cache


def _prefill_mix(p, cfg: ModelConfig, ls: LayerSpec, h, c, positions):
    """A layer's token mixer over the normed ``h`` through the kernels,
    from the layer's cache ``c``. Returns (the mix, the filled cache)."""
    if ls.mixer == "rwkv":
        mix, state = rwkv6.rwkv6_prefill(p["rwkv"], rwkv_spec(cfg), h,
                                         c["rwkv"])
        return mix, {"rwkv": state}
    if ls.mixer == "mamba":
        mix, state = mamba.mamba_prefill(p["mamba"], mamba_spec(cfg), h,
                                         c["mamba"])
        return mix, {"mamba": state}
    mix, kv = attention.prefill_attention(p["attn"], attn_spec(cfg, ls), h,
                                          positions, c["kv"])
    return mix, {"kv": kv}


def _prefill_layer(p, cfg: ModelConfig, ls: LayerSpec, x, c, positions,
                   enc_out=None):
    """``_layer_forward`` through the kernels that also fills the layer's
    decode cache (attention's KV slots; mamba's SSM state and conv ring;
    rwkv's WKV state and token shifts)."""
    mix, cnew = _prefill_mix(p, cfg, ls, _norm(cfg, p["norm1"], x), c,
                             positions)
    x = x + mix
    if enc_out is not None:
        x = _cross(p, cfg, x, positions, enc_out, kernel=True)
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
    cache directly (an encoder-decoder's ``enc_out`` too). Returns
    ``(last-position logits (B, V), cache)`` — the logits that predict the
    first generated token."""
    check_ported(cfg)
    x, positions, enc_out = embed_inputs(params, cfg, batch, kernel=True)
    if enc_out is not None:
        cache["enc_out"] = enc_out.to(cache["enc_out"].dtype)
    for i, (p, ls) in enumerate(zip(params["layers"], cfg.layer_specs(),
                                    strict=True)):
        x, cache["layers"][i] = _prefill_layer(p, cfg, ls, x,
                                               cache["layers"][i], positions,
                                               enc_out)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return unembed(params, cfg, x)[:, 0], cache


def _cross_decode(p, cfg: ModelConfig, x, enc_out):
    """Cross attention for one decode token, plain, as the reference: the
    encoder's keys and values are projected again at every step (the
    cache holds only the encoder's output). The query position is 0: cross
    attention is non-causal and whisper's positions are learned, not
    rotary, so it is exact."""
    q_pos = torch.zeros((1,), dtype=torch.long, device=x.device)
    return _cross(p, cfg, x, q_pos, enc_out, kernel=False)
