"""Attention: the port of ``repro/models/attention.py``. GQA with RoPE and
optional qk-norm (an RMSNorm of each query and key head before RoPE);
full / sliding-window / chunked-local patterns; full-sequence attention,
prefill that also fills the decode cache, and single-token decode.

Prefill's attention, and the training loss's (``kernel_attention``), runs
through the hand-written flash kernel (``kernels.flash_attention``).
``attention_block`` (the full forward's attention) is the reference's
``blockwise_attention`` in plain PyTorch: query blocks of 512 ride as a
batch dimension and a loop walks the keys in blocks of 1024 with an
online softmax, so no (Sq, Sk) score tensor is ever whole. It computes in
the input's dtype's accumulation type (float64 for float64), so that the
full forward also runs in float64 as a reference on the card. Decode is
plain PyTorch, as in the reference, where no Pallas kernel lies on it.

A padded key (the blockwise form pads the keys to a multiple of the key
block) adds nothing in every pattern, as in the flash kernel and its
plain version ``kernels.ref.flash_attention_ref``. The reference's
``blockwise_attention`` masks padded keys only under the causal and
chunked masks, so its non-causal attention over Sk keys, Sk not a
multiple of the key block, counts Sk_padded − Sk zero keys in the
softmax (ROADMAP, the reference's fault i); the port does not.

Both full-sequence forms take ``kv_x``: the keys and values are then
projected from ``kv_x`` (at ``kv_positions``) instead of ``x``, which is
cross attention (whisper's decoder over the encoder's output), and
``causal=False`` drops the causal mask (the encoder, and cross attention).

Patterns (``kind``):
  * ``full``     — causal.
  * ``sliding``  — causal ∧ (i − j < window)
  * ``chunked``  — causal ∧ (i//chunk == j//chunk)

The caches are updated in place (the reference returns new arrays): a
40-layer cache of 2.7 GB is not copied per token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..distributed.context import maybe_constrain, write_slots
from ..kernels.flash_attention import flash_attention
from ..launch import op_costs
from . import layers

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "full"              # full | sliding | chunked
    window: int = 0                 # for sliding / chunked
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def attn_init(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype):
    p = {
        "wq": layers.dense_init(gen, (d_model, spec.num_heads, spec.head_dim), dtype),
        "wk": layers.dense_init(gen, (d_model, spec.num_kv_heads, spec.head_dim), dtype),
        "wv": layers.dense_init(gen, (d_model, spec.num_kv_heads, spec.head_dim), dtype),
        "wo": layers.dense_init(gen, (spec.num_heads, spec.head_dim, d_model), dtype,
                                scale=1.0 / (spec.num_heads * spec.head_dim) ** 0.5),
    }
    if spec.qk_norm:     # ones: no draw from the generator
        p["q_norm"] = layers.rmsnorm_init(spec.head_dim, dtype, gen.device)
        p["k_norm"] = layers.rmsnorm_init(spec.head_dim, dtype, gen.device)
    return p


def _masks(spec: AttnSpec) -> dict:
    """The pattern as the flash kernel's window and chunk arguments."""
    return {"window": spec.window if spec.kind == "sliding" else 0,
            "chunk": spec.window if spec.kind == "chunked" else 0}


def _readable(t: torch.Tensor) -> bool:
    """A real CPU tensor: one whose values can be read without waiting
    for a card (a fake tensor of a dry run has none)."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "cpu" and not is_fake(t)


def _check_arange(positions: torch.Tensor, s: int) -> None:
    """The attention's query and key positions are the indices 0 .. S−1.
    The shape is checked on every device; the values only on the CPU
    (and not on a dry run's fake tensors, which have none), since reading
    a card's tensor waits for the card. On the card the
    positions come from ``transformer.embed_inputs``'s ``torch.arange``,
    so prefill runs with no sync to the host and can be captured."""
    if tuple(positions.shape) != (s,):
        raise ValueError(f"full-sequence positions must be arange(S): shape "
                         f"{tuple(positions.shape)}, S = {s}")
    if _readable(positions) and not torch.equal(
            positions, torch.arange(s, dtype=positions.dtype)):
        raise ValueError("full-sequence positions must be arange(S)")


def _qkv(params, spec: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
         kv_x: Optional[torch.Tensor] = None,
         kv_positions: Optional[torch.Tensor] = None):
    """q from ``x`` at ``positions``; k and v from ``kv_x`` at
    ``kv_positions`` (by default ``x`` and ``positions``)."""
    src = x if kv_x is None else kv_x
    src_pos = positions if kv_positions is None else kv_positions
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, params["wv"])
    if spec.qk_norm:     # over head_dim, before RoPE, as the reference
        q = layers.rmsnorm(params["q_norm"], q)
        k = layers.rmsnorm(params["k_norm"], k)
    if spec.rope:
        q = layers.apply_rope(q, positions, spec.rope_theta)
        k = layers.apply_rope(k, src_pos, spec.rope_theta)
    return q, k, v


def _checked_qkv(params, spec: AttnSpec, x, positions, kv_x, kv_positions):
    """``_qkv`` of a full sequence, each side's positions checked to be
    the indices of its own sequence; k and v take the "kv_full" layout of
    an active sharding context (every query block needs the whole key
    range)."""
    _check_arange(positions, x.shape[1])
    if kv_x is not None:
        _check_arange(positions if kv_positions is None else kv_positions,
                      kv_x.shape[1])
    q, k, v = _qkv(params, spec, x, positions, kv_x, kv_positions)
    return q, maybe_constrain(k, "kv_full"), maybe_constrain(v, "kv_full")


def _allowed(spec: AttnSpec, q_pos: torch.Tensor, k_pos: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query may attend to under the pattern
    (the reference's ``_mask_bias``, as a mask)."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if spec.kind == "sliding":
        ok &= diff < spec.window
    elif spec.kind == "chunked":
        ok &= (q_pos[:, None] // spec.window) == (k_pos[None, :] // spec.window)
    return ok


def _pad_seq(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """``x`` padded by ``n`` entries of ``value`` along dim 1 (dim 0 for a
    1-d tensor)."""
    if n == 0:
        return x
    dim = 0 if x.dim() == 1 else 1
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def blockwise_attention(spec: AttnSpec, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, q_positions: torch.Tensor,
                        k_positions: torch.Tensor, causal: bool = True,
                        q_block: int = 512, k_block: int = 1024
                        ) -> torch.Tensor:
    """Memory-efficient attention (the reference's ``blockwise_attention``):
    all query blocks ride as one batch dimension, a loop walks the KV
    blocks with an online softmax. Never materialises (Sq, Sk): one pass
    holds (B, H, Sq, k_block) scores.

    q (B, Sq, H, hd); k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hdv) (latent
    attention's values are narrower than its queries and keys); positions
    (Sq,) and (Sk,). Returns (B, Sq, H, hdv) in q's dtype, accumulated in
    ``layers.acc_dtype(q.dtype)``. A key padded onto the last block adds
    nothing to the running max, sum or accumulator in any pattern; a query
    with no valid key gets the mean of v over the Sk keys, as
    ``kernels.ref.flash_attention_ref``."""
    b, sq, h, hd = q.shape
    sk, hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    # shard-friendliness: the q-block reshape splits S into (n_blocks,
    # block); with fewer blocks than the model axis (16) an S-sharded q
    # would be gathered. Keep ≥ 16 query blocks for long sequences.
    if sq >= 16 * 128:
        q_block = min(q_block, sq // 16)
    q_block = min(q_block, sq)
    k_block = min(k_block, sk)
    nq, nk = -(-sq // q_block), -(-sk // k_block)
    sq_p, sk_p = nq * q_block, nk * k_block
    acc_t = layers.acc_dtype(q.dtype)

    qpos = _pad_seq(q_positions, sq_p - sq, -(10 ** 9))
    kpos = _pad_seq(k_positions, sk_p - sk, 10 ** 9)
    # (B, Hkv, G, nq·qb, hd): the query blocks stay on the sequence dim,
    # outermost, so that an S-sharded q keeps its sharding
    qh = _pad_seq(q, sq_p - sq).reshape(b, nq, q_block, hkv, g, hd).permute(
        0, 3, 4, 1, 2, 5).reshape(b, hkv, g, sq_p, hd).to(acc_t)
    kp = _pad_seq(k, sk_p - sk).to(acc_t)
    vp = _pad_seq(v, sk_p - sk).to(acc_t)

    # the running state takes q's layout (``*_like``: under a sharding
    # context its batch and sequence shards, not a replicated whole)
    acc = torch.zeros_like(qh if hdv == hd else qh[..., :hdv])
    m = torch.full_like(qh[..., 0], NEG_INF)
    l = torch.zeros_like(qh[..., 0])
    # one pass traced under a folding ``launch.op_costs`` recorder: the
    # passes are the same ops at the same shapes (the last block padded)
    for j in op_costs.passes(nk):
        lo = j * k_block
        kc = kp[:, lo:lo + k_block].permute(0, 2, 3, 1)[:, :, None]
        vc = vp[:, lo:lo + k_block].transpose(1, 2)[:, :, None]
        ok = _allowed(spec, qpos, kpos[lo:lo + k_block], causal)
        # (B, Hkv, G, Sq_p, kb); out of place: under a sharding context
        # the product may be a partial sum, which an in-place op refuses
        s = torch.where(ok, torch.matmul(qh, kc) * spec.scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        if lo + k_block > sk:                    # the padded keys: none
            p.masked_fill_(torch.arange(lo, lo + k_block, device=q.device)
                           >= sk, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vc)
        m = m_new
        del s, p, ok
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    # (B, Hkv, G, Sq_p, hdv) → (B, Sq, H, hdv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, h, hdv)
    return out[:, :sq]


def attention_block(params, spec: AttnSpec, x: torch.Tensor,
                    positions: torch.Tensor,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Self (or, with ``kv_x``, cross) attention over a full sequence (the
    full forward, train and prefill), through ``blockwise_attention`` in
    plain PyTorch, in float64 for a float64 input."""
    q, k, v = _checked_qkv(params, spec, x, positions, kv_x, kv_positions)
    src_pos = positions if kv_positions is None else kv_positions
    out = blockwise_attention(spec, q, k, v, positions, src_pos,
                              causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def _kernel_attention(params, spec: AttnSpec, x: torch.Tensor,
                      positions: torch.Tensor,
                      kv_x: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      causal: bool = True):
    """``attention_block`` through the flash kernel. Returns (the block's
    output, k, v)."""
    q, k, v = _checked_qkv(params, spec, x, positions, kv_x, kv_positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=causal, scale=spec.scale, **_masks(spec))
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), k, v


def kernel_attention(params, spec: AttnSpec, x: torch.Tensor,
                     positions: torch.Tensor,
                     kv_x: Optional[torch.Tensor] = None,
                     kv_positions: Optional[torch.Tensor] = None,
                     causal: bool = True) -> torch.Tensor:
    """Self (or, with ``kv_x``, cross) attention over a full sequence
    through the flash kernel, with no cache: the training loss's
    attention, the encoder's (``causal=False``) and cross attention in
    prefill (``kv_x``, ``causal=False``)."""
    return _kernel_attention(params, spec, x, positions, kv_x, kv_positions,
                             causal)[0]


def prefill_attention(params, spec: AttnSpec, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
    """Full-sequence causal self-attention through the flash kernel that
    ALSO writes the decode KV cache: exactly the slots S teacher-forced
    ``decode_attention`` steps would have filled (slot = pos % L; of
    positions sharing a slot only the latest survives, so only the last L
    prompt positions are written).

    FULL attention over a ring smaller than the prompt is not
    decode-equivalent and is rejected, as in the reference."""
    b, s, _ = x.shape
    if spec.kind == "full" and s > cache["k"].shape[1]:
        raise ValueError(
            f"prefill of a {s}-token prompt into a {cache['k'].shape[1]}"
            "-slot full-attention cache is not decode-equivalent; size "
            "the cache to at least the prompt length")
    y, k, v = _kernel_attention(params, spec, x, positions)

    length = cache["k"].shape[1]
    start = max(0, s - length)
    slots = torch.arange(start, s, device=x.device) % length
    cache["k"][:, slots] = k[:, start:s].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, start:s].to(cache["v"].dtype)
    return y, cache


# ---------------------------------------------------------------------------
# decode (single token against a cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, spec: AttnSpec, max_len: int, dtype, device):
    """Cache length for windowed/chunked patterns is bounded by the window."""
    length = cache_length(spec, max_len)
    shape = (batch, length, spec.num_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_length(spec: AttnSpec, max_len: int) -> int:
    if spec.kind in ("sliding", "chunked") and spec.window > 0:
        return min(max_len, spec.window)
    return max_len


def decode_attention(params, spec: AttnSpec, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); pos: (B,) current absolute position.

    The cache is a rolling buffer of length L = cache_length: slot = pos % L.
    The new key and value go in by an indexed write, which gives the
    reference's one-hot blend for a finite cache. For ``chunked`` the mask
    drops entries from previous chunks.
    """
    b = x.shape[0]
    length = cache["k"].shape[1]
    q, k_new, v_new = _qkv(params, spec, x, pos[:, None])

    slot = pos % length                                   # (B,)
    write_slots(cache["k"], slot, k_new[:, 0].to(cache["k"].dtype))
    write_slots(cache["v"], slot, v_new[:, 0].to(cache["v"].dtype))
    k, v = cache["k"], cache["v"]

    # absolute position of every cache slot given current pos: slot s holds
    # the largest p ≤ pos with p % L == s
    idx = torch.arange(length, device=x.device)[None, :]  # (1, L)
    cache_pos = pos[:, None] - ((pos[:, None] - idx) % length)
    valid = cache_pos >= 0
    if spec.kind == "sliding" and spec.window > 0:
        valid &= (pos[:, None] - cache_pos) < spec.window
    elif spec.kind == "chunked" and spec.window > 0:
        valid &= (cache_pos // spec.window) == (pos[:, None] // spec.window)

    hkv = spec.num_kv_heads
    g = spec.num_heads // hkv
    acc_t = layers.acc_dtype(x.dtype)
    qr = q.reshape(b, 1, hkv, g, spec.head_dim)
    s = torch.einsum("bqhgd,blhd->bhgql", qr.to(acc_t),
                     k.to(acc_t)) * spec.scale
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgql,blhd->bqhgd", p.to(v.dtype).to(acc_t),
                       v.to(acc_t))
    out = out.reshape(b, 1, spec.num_heads, spec.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, cache
