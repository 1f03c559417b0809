"""The JAX reference's LM outputs for the port's tests, dumped to an npz.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_lm_ref.py OUT.npz [PART [ARCH ...]]

``repro.models`` does not import on this jax (ROADMAP queue 3, item a):
``models/attention.py:172`` asks ``prim in batching.primitive_batchers``,
and that attribute is now a proxy that does not support ``in``. For the
length of the import only, this script puts a plain dict holding the
barrier primitive in its place, so the reference registers no rule of its
own, then restores the proxy. No file of the reference changes. It runs
in a process of its own (``tests/test_torch_lm.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_rwkv6.py``,
``tests/test_torch_mamba.py`` and ``tests/test_torch_gemma3.py`` start
it), so no other test module ever sees the swap.

Eleven parts (PART): ``lm`` (the default) dumps the models, ``moe`` the MoE
layer's pieces, ``rwkv`` the rwkv6 pieces and the rwkv6-7b-smoke model (at
2 layers, unrolled, and at 4, scanned as plan (0, 1, 4, 0)), ``mamba`` the
mamba pieces and the jamba-v0.1-52b-smoke model (at 2 layers, unrolled,
and at 8, scanned as plan (0, 2, 4, 0)) with 128-token prompts, twice its
attention window of 64, ``gemma`` the qk-norm attention pieces (sliding
and global, at head_dim 64 and 256) and the gemma3-4b-smoke model (at 2
layers, unrolled, and at 8, scanned as plan (0, 2, 4, 0); at 2 layers with
head_dim 256; and a 34-layer model of gemma3-4b's layer pattern at tiny
widths, plan (0, 6, 5, 4)) with 128-token prompts, twice its window of
64, and ``netes`` the distributed replica step (``repro.distributed.
netes_dist``) and ``loss_fn`` of gemma3-4b-smoke and moonshot-v1-16b-a3b-
smoke at N = 4 agents with 64-token sequences (see ``dump_netes``), and
``llama4`` the chunked qk-norm attention pieces, the MoE layer at E = 16
and 128 with top-1, and the llama4 smoke models and 48-layer models of
their patterns at tiny widths (see ``dump_llama4``), and ``frontends``
cross and non-causal attention pieces, whisper-tiny-smoke with the
frontend's frames and llava-next-mistral-7b-smoke with its patches (see
``dump_frontends``), ``consensus`` the consensus step
(``make_consensus_train_step``, see ``dump_consensus``) and ``sharding``
the placement of ``repro.launch.specs`` on the production meshes (see
``dump_sharding``; run with 512 forced host devices, written as JSON)
and ``dryrun`` the reference's ``hlo_costs`` of four smoke pairs on a
mesh of one (see ``dump_dryrun``, written as JSON), and ``blockwise`` the
reference's ``blockwise_attention`` at small blocks over its patterns,
``attention_block`` across its default blocks, the non-causal case whose
padded keys it counts (ROADMAP, the reference's fault i) and standard
ES's ``es_step`` on a landscape with its ε (see ``dump_blockwise``).
The ``netes`` part's archs include whisper-tiny-smoke, whose batches
carry the reference's frames. The ``netes`` and ``consensus`` parts take
ARCH names: the dump then holds those archs alone, each as the whole
part's dump holds it (an arch's inputs and draws depend on its index in
``NETES_ARCHS`` or ``CONS_ARCHS`` only), so that test files can split the
archs between them (``tests/_torch_ref_dumps.py``).
Everything is drawn from fixed seeds: the weights
with the reference's own inits (mistral-nemo-12b-smoke at 2 layers,
unrolled, and at 4 layers, scanned; moonshot-v1-16b-a3b-smoke at 2
layers, unrolled, and at 6 layers, scanned as plan (1, 1, 5, 0): one
dense head layer, then one MoE layer 5 times), the inputs with numpy.
Keys are "/"-joined paths.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax._src.lax.lax import optimization_barrier_p
from jax.interpreters import batching

from repro.configs import get_config

B, PROMPT, NEW, STEPS, MAX_LEN, FWD_LEN = 2, 8, 6, 4, 16, 10


def import_reference():
    saved = batching.primitive_batchers
    batching.primitive_batchers = {optimization_barrier_p: None}
    try:
        from repro.models import attention, layers, moe, transformer
        from repro.serve import ServeEngine
    finally:
        batching.primitive_batchers = saved
    return attention, layers, moe, transformer, ServeEngine


def flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix, *parts])] = np.asarray(leaf)
    return out


def dump_model(out, transformer, ServeEngine, cfg, p, key, rng,
               prompt=PROMPT, fwd_len=FWD_LEN, max_len=MAX_LEN, extra=None):
    """``cfg``'s weights from ``PRNGKey(key)`` and its outputs under the
    keys ``p/...``: forward, prefill with its cache, 4 teacher-forced
    decode steps with the cache after them, greedy ``generate``. The
    frontends' inputs ``extra`` go into the forward and ``generate``, and
    into the prefill but for ``patch_embeds``, which the reference's
    serving drops."""
    v = cfg.vocab_size
    extra = extra or {}
    served = {k: a for k, a in extra.items() if k != "patch_embeds"}
    params = transformer.init_params(jax.random.PRNGKey(key), cfg,
                                     jnp.float32)
    out.update(flatten(params, f"{p}/params"))
    tokens = rng.integers(0, v, (B, fwd_len)).astype(np.int32)
    out[f"{p}/forward_tokens"] = tokens
    out[f"{p}/forward_logits"] = transformer.forward(
        params, cfg, {"tokens": tokens, **extra})
    prompts = rng.integers(0, v, (B, prompt)).astype(np.int32)
    cache = transformer.init_cache(cfg, B, max_len, jnp.float32)
    last, cache = transformer.prefill(params, cfg,
                                      {"tokens": prompts, **served}, cache)
    out.update({f"{p}/prompts": prompts, f"{p}/prefill_logits": last})
    out.update(flatten(cache, f"{p}/prefill_cache"))
    steps = rng.integers(0, v, (B, STEPS)).astype(np.int32)
    logits = []
    for i in range(STEPS):
        lg, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            jnp.full((B,), prompt + i, jnp.int32))
        logits.append(np.asarray(lg))
    out.update({f"{p}/decode_tokens": steps,
                f"{p}/decode_logits": np.stack(logits)})
    out.update(flatten(cache, f"{p}/decode_cache"))
    engine = ServeEngine(cfg, params, max_len=max_len)
    out[f"{p}/generate_tokens"] = engine.generate(jnp.asarray(prompts),
                                                  new_tokens=NEW,
                                                  extra_batch=extra)
    return params


def main(path, part="lm", *archs):
    attention, layers, moe, transformer, ServeEngine = import_reference()
    if part == "moe":
        np.savez(path, **dump_moe(moe))
        return
    if part == "rwkv":
        np.savez(path, **dump_rwkv(transformer, ServeEngine))
        return
    if part == "mamba":
        np.savez(path, **dump_mamba(transformer, ServeEngine))
        return
    if part == "gemma":
        np.savez(path, **dump_gemma(attention, transformer, ServeEngine))
        return
    if part == "netes":
        np.savez(path, **dump_netes(transformer, archs or NETES_ARCHS))
        return
    if part == "llama4":
        np.savez(path, **dump_llama4(attention, moe, transformer,
                                     ServeEngine))
        return
    if part == "frontends":
        np.savez(path, **dump_frontends(attention, transformer, ServeEngine))
        return
    if part == "consensus":
        np.savez(path, **dump_consensus(transformer, archs or CONS_ARCHS))
        return
    if part == "sharding":
        with open(path, "w") as f:
            json.dump(dump_sharding(), f)
        return
    if part == "dryrun":
        with open(path, "w") as f:
            json.dump(dump_dryrun(), f)
        return
    if part == "blockwise":
        np.savez(path, **dump_blockwise(attention))
        return
    smoke = get_config("mistral-nemo-12b-smoke")
    rng = np.random.default_rng(0)
    d, v = smoke.d_model, smoke.vocab_size
    out = {}

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    # ---- building blocks ------------------------------------------------
    x = normal(B, 5, d)
    scale, bias = normal(d), normal(d)
    out.update({"rmsnorm/x": x, "rmsnorm/scale": scale,
                "rmsnorm/out": layers.rmsnorm({"scale": scale}, x),
                "layernorm/scale": scale, "layernorm/bias": bias,
                "layernorm/out": layers.layernorm(
                    {"scale": scale, "bias": bias}, x)})
    xr = normal(B, 5, smoke.num_heads, smoke.head_dim)
    pos = rng.integers(0, 9000, (B, 5)).astype(np.int32)
    out.update({"rope/x": xr, "rope/positions": pos,
                "rope/out": layers.apply_rope(xr, pos, smoke.rope_theta)})
    gelu = layers.gelu_mlp_init(jax.random.PRNGKey(7), d, smoke.d_ff,
                                jnp.float32)
    out.update(flatten(gelu, "gelu/params"))
    out["gelu/out"] = layers.gelu_mlp(gelu, x)

    for n_layers in (2, 4):
        cfg = dataclasses.replace(smoke, num_layers=n_layers)
        params = dump_model(out, transformer, ServeEngine, cfg,
                            f"p{n_layers}", n_layers, rng)
        if n_layers == 2:
            lay = params["layers_head"][0]
            out["swiglu/out"] = layers.swiglu(lay["ffn"], x)
            spec = transformer.attn_spec(cfg, cfg.layer_specs()[0])
            xa = normal(B, PROMPT, d)
            kv = attention.init_kv_cache(B, spec, MAX_LEN - 4, jnp.float32)
            y, kv = attention.prefill_attention(
                lay["attn"], spec, xa, jnp.arange(PROMPT), kv)
            out.update({"prefill_attention/x": xa,
                        "prefill_attention/out": y,
                        "prefill_attention/k": kv["k"],
                        "prefill_attention/v": kv["v"]})
            # row 0 appends at position 8; row 1 at 13 wraps the 12-slot
            # ring onto slot 1
            x1 = normal(B, 1, d)
            dpos = np.array([PROMPT, 13], np.int32)
            y, kv = attention.decode_attention(lay["attn"], spec, x1, kv,
                                               jnp.asarray(dpos))
            out.update({"decode_attention/x": x1,
                        "decode_attention/pos": dpos,
                        "decode_attention/out": y,
                        "decode_attention/k": kv["k"],
                        "decode_attention/v": kv["v"]})
    moon = get_config("moonshot-v1-16b-a3b-smoke")
    moon_rng = np.random.default_rng(1)
    for n_layers in (2, 6):
        cfg = dataclasses.replace(moon, num_layers=n_layers)
        dump_model(out, transformer, ServeEngine, cfg, f"moon{n_layers}",
                   100 + n_layers, moon_rng)
    np.savez(path, **{k: np.asarray(a) for k, a in out.items()})


# (E, k, capacity) of the dispatch dump: 12 tokens × 2 choices into 4
# experts of 3 slots, so choices overflow
DISPATCH = (4, 2, 3)
# the two MoE-layer specs: with drops (capacity factor 0.5: 4 slots per
# expert for 16 tokens × 2 choices) and without (capacity factor 8)
MOE_SPECS = {"drops": dict(num_experts=4, experts_per_token=2, d_model=32,
                           d_ff=64, capacity_factor=0.5, group_size=16),
             "nodrops": dict(num_experts=4, experts_per_token=2, d_model=32,
                             d_ff=64, capacity_factor=8.0, group_size=64)}


def dump_moe(moe):
    rng = np.random.default_rng(2)
    out = {}
    e, k, cap = DISPATCH
    ids = np.stack([rng.permuted(np.tile(np.arange(e), (12, 1)), axis=1)[:, :k]
                    for _ in range(3)]).astype(np.int32)    # (3, 12, 2)
    out["dispatch/ids"] = ids
    res = [moe._dispatch_indices(jnp.asarray(g), k, e, cap) for g in ids]
    out["dispatch/idx"] = np.stack([np.asarray(i) for i, _ in res])
    out["dispatch/dst"] = np.stack([np.asarray(d) for _, d in res])
    for name, kw in MOE_SPECS.items():
        spec = moe.MoESpec(**kw)
        params = moe.moe_init(jax.random.PRNGKey(len(name)), spec,
                              jnp.float32)
        out.update(flatten(params, f"{name}/params"))
        x = rng.standard_normal((2, 2 * kw["group_size"], kw["d_model"])
                                ).astype(np.float32)
        out[f"{name}/x"] = x
        out[f"{name}/moe_block"] = moe.moe_block(params, spec, x)
        out[f"{name}/moe_ref"] = moe.moe_ref(params, spec, x)
        out[f"{name}/load_balance_loss"] = moe.load_balance_loss(params,
                                                                 spec, x)
    return {key: np.asarray(a) for key, a in out.items()}


# the rwkv pieces: a time mix of d 64 in 2 heads of 32, sequences of 48
# (a multiple of the chunk) and 40 (not: the sequential fallback)
RWKV_D, RWKV_HEADS, RWKV_CHUNK, RWKV_FF = 64, 2, 16, 128


def dump_rwkv(transformer, ServeEngine):
    from repro.models import rwkv6
    rng = np.random.default_rng(3)
    out = {}

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    spec = rwkv6.RWKV6Spec(d_model=RWKV_D, num_heads=RWKV_HEADS)
    h, n = spec.num_heads, spec.head_dim
    params = rwkv6.rwkv6_init(jax.random.PRNGKey(11), spec, jnp.float32)
    # away from the init's constants, so that every term moves the output:
    # mixes in (0, 1), LoRAs of scale ≈ 1, decays w in (0.69, 0.98)
    params = dict(params)
    params["mix"] = rng.uniform(0, 1, (5, RWKV_D)).astype(np.float32)
    for name in ("mix_lora", "decay_lora"):
        lora = dict(params[name])
        lora["a"] = normal(*lora["a"].shape, scale=0.3)
        lora["b"] = normal(*lora["b"].shape, scale=0.3)
        lora["bias"] = normal(RWKV_D, scale=0.1)
        params[name] = lora
    params["decay_base"] = rng.uniform(-4, -1.5, RWKV_D).astype(np.float32)
    params["bonus_u"] = normal(h, n)
    params["ln_x"] = {"scale": 1 + normal(RWKV_D, scale=0.1),
                      "bias": normal(RWKV_D, scale=0.1)}
    out.update(flatten(params, "block/params"))
    x = normal(B, 48, RWKV_D)
    last = normal(B, 1, RWKV_D)
    out.update({"block/x": x, "block/last": last,
                "time_shift/zero": rwkv6._time_shift(jnp.asarray(x)),
                "time_shift/last": rwkv6._time_shift(jnp.asarray(x),
                                                     jnp.asarray(last))})
    mixed = rwkv6._mix_inputs(params, jnp.asarray(x),
                              rwkv6._time_shift(jnp.asarray(x)))
    for name, m in zip("rkvwg", mixed):
        out[f"mix_inputs/{name}"] = m
    for s in (48, 40):
        r, k, v = (normal(B, s, h, n) for _ in range(3))
        w = rng.uniform(0.7, 0.999, (B, s, h, n)).astype(np.float32)
        u, s0 = normal(h, n), normal(B, h, n, n)
        o, sf = rwkv6.wkv6_chunked(r, k, v, w, u, chunk=RWKV_CHUNK)
        o0, sf0 = rwkv6.wkv6_chunked(r, k, v, w, u, s0=s0, chunk=RWKV_CHUNK)
        out.update({f"wkv{s}/r": r, f"wkv{s}/k": k, f"wkv{s}/v": v,
                    f"wkv{s}/w": w, f"wkv{s}/u": u, f"wkv{s}/s0": s0,
                    f"wkv{s}/out": o, f"wkv{s}/s_fin": sf,
                    f"wkv{s}/out_s0": o0, f"wkv{s}/s_fin_s0": sf0})
    out["block/out"] = rwkv6.rwkv6_block(params, spec, jnp.asarray(x),
                                         chunk=RWKV_CHUNK)
    zero = rwkv6.init_rwkv_cache(B, spec, jnp.float32)
    seeded = {"s": normal(B, h, n, n, scale=0.3), "x_prev": last}
    out.update(flatten(seeded, "prefill/seed"))
    for name, cache in (("zero", zero), ("seeded", seeded)):
        y, c = rwkv6.rwkv6_prefill(params, spec, jnp.asarray(x[:, :40]),
                                   cache)
        out[f"prefill/{name}/out"] = y
        out.update(flatten(c, f"prefill/{name}/cache"))
        if name == "seeded":
            # teacher-forced decode steps on the seeded prefill's cache
            ys = []
            for t in range(40, 44):
                yt, c = rwkv6.rwkv6_decode(params, spec,
                                           jnp.asarray(x[:, t:t + 1]), c)
                ys.append(np.asarray(yt))
            out["decode/out"] = np.concatenate(ys, axis=1)
            out.update(flatten(c, "decode/cache"))
    chan = rwkv6.rwkv6_channel_init(jax.random.PRNGKey(12), RWKV_D, RWKV_FF,
                                    jnp.float32)
    chan = dict(chan, mix_k=rng.uniform(0, 1, RWKV_D).astype(np.float32),
                mix_r=rng.uniform(0, 1, RWKV_D).astype(np.float32))
    out.update(flatten(chan, "channel/params"))
    out["channel/out"] = rwkv6.rwkv6_channel(chan, jnp.asarray(x))
    out["channel/out_last"] = rwkv6.rwkv6_channel(chan, jnp.asarray(x),
                                                  jnp.asarray(last))

    smoke = get_config("rwkv6-7b-smoke")
    model_rng = np.random.default_rng(4)
    for n_layers in (2, 4):
        cfg = dataclasses.replace(smoke, num_layers=n_layers)
        dump_model(out, transformer, ServeEngine, cfg, f"rwkv{n_layers}",
                   200 + n_layers, model_rng)
    return {key: np.asarray(a) for key, a in out.items()}


# the mamba pieces: d_model 32 (d_inner 64, d_state 8, dt rank 2) over
# sequences of 48, its chunked path in chunks of 16; the jamba smoke model
# with prompts and a forward of 128 tokens (two MoE groups of 64, twice
# the sliding window of 64) and a cache of 136 positions
MAMBA_D, MAMBA_STATE, MAMBA_CHUNK = 32, 8, 16
JAMBA_PROMPT, JAMBA_MAX_LEN = 128, 136


def dump_mamba(transformer, ServeEngine):
    from repro.models import mamba
    rng = np.random.default_rng(5)
    out = {}
    spec = mamba.MambaSpec(d_model=MAMBA_D, d_state=MAMBA_STATE)
    di = spec.d_inner
    params = dict(mamba.mamba_init(jax.random.PRNGKey(13), spec,
                                   jnp.float32))
    # away from the init's constants, so that every term moves the output:
    # steps Δ ≈ 0.05–0.3, per-channel A, a random skip D and conv bias
    params["dt_bias"] = rng.uniform(-3, -1, di).astype(np.float32)
    params["A_log"] = rng.uniform(-1, 1, (di, MAMBA_STATE)).astype(np.float32)
    params["D"] = rng.standard_normal(di).astype(np.float32)
    params["conv_b"] = (0.1 * rng.standard_normal(di)).astype(np.float32)
    out.update(flatten(params, "block/params"))
    x = rng.standard_normal((B, 48, MAMBA_D)).astype(np.float32)
    out["block/x"] = x
    xin, z = mamba._ssm_inputs(params, spec, jnp.asarray(x))
    xc = mamba._causal_conv(params, spec, xin)
    decay, drive, c = mamba._selective_terms(params, spec, xc)
    out.update({"ssm_inputs/x": xin, "ssm_inputs/z": z, "causal_conv/out": xc,
                "selective/decay": decay, "selective/drive": drive,
                "selective/c": c,
                "scan/h": mamba.mamba_scan_ref(decay, drive)})
    out["block/out"] = mamba.mamba_block(params, spec, jnp.asarray(x))
    out["block/out_chunked"] = mamba.mamba_block(params, spec, jnp.asarray(x),
                                                 chunk=MAMBA_CHUNK)
    for s in (40, 2):          # a prompt, and one shorter than the ring
        y, c = mamba.mamba_prefill(params, spec, jnp.asarray(x[:, :s]),
                                   mamba.init_mamba_cache(B, spec,
                                                          jnp.float32))
        out[f"prefill{s}/out"] = y
        out.update(flatten(c, f"prefill{s}/cache"))
        if s == 40:
            ys = []
            for t in range(40, 44):
                yt, c = mamba.mamba_decode(params, spec,
                                           jnp.asarray(x[:, t:t + 1]), c)
                ys.append(np.asarray(yt))
            out["decode/out"] = np.concatenate(ys, axis=1)
            out.update(flatten(c, "decode/cache"))

    smoke = get_config("jamba-v0.1-52b-smoke")
    model_rng = np.random.default_rng(6)
    for n_layers in (2, 8):
        cfg = dataclasses.replace(smoke, num_layers=n_layers)
        dump_model(out, transformer, ServeEngine, cfg, f"jamba{n_layers}",
                   300 + n_layers, model_rng, prompt=JAMBA_PROMPT,
                   fwd_len=JAMBA_PROMPT, max_len=JAMBA_MAX_LEN)
    return {key: np.asarray(a) for key, a in out.items()}


# the gemma pieces: qk-norm attention of the smoke's widths (d 256, 4/2
# heads) at head_dim 64 and 256, sliding (window 64) and global, over a
# 100-token input whose prefill wraps the 64-slot ring; the models with
# prompts and a forward of 128 tokens and a cache of 136 positions
GEMMA_PIECE_LEN, GEMMA_PROMPT, GEMMA_MAX_LEN = 100, 128, 136
GEMMA_HEAD_DIMS = (64, 256)
GEMMA_KINDS = {"sliding": 0, "global": 1}     # layer of the smoke config
# a 34-layer model of gemma3-4b's pattern (5 sliding, 1 global, stacked
# 5 times, then 4 sliding) at tiny widths, window 8
GEMMA_TINY = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                  d_ff=64, vocab_size=64, sliding_window=8)
GEMMA_TINY_PROMPT, GEMMA_TINY_MAX_LEN = 16, 24


def dump_gemma(attention, transformer, ServeEngine):
    rng = np.random.default_rng(8)
    out = {}
    smoke = get_config("gemma3-4b-smoke")
    d = smoke.d_model

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for hd in GEMMA_HEAD_DIMS:
        cfg = dataclasses.replace(smoke, head_dim=hd)
        for kind, layer in GEMMA_KINDS.items():
            p = f"attn{hd}_{kind}"
            spec = transformer.attn_spec(cfg, cfg.layer_specs()[layer])
            params = dict(attention.attn_init(jax.random.PRNGKey(hd + layer),
                                              d, spec, jnp.float32))
            # away from the init's ones, so that the scales move the output
            params["q_norm"] = {"scale": 1 + normal(hd, scale=0.3)}
            params["k_norm"] = {"scale": 1 + normal(hd, scale=0.3)}
            out.update(flatten(params, f"{p}/params"))
            x = normal(B, GEMMA_PIECE_LEN, d)
            pos = jnp.arange(GEMMA_PIECE_LEN)
            out[f"{p}/x"] = x
            out[f"{p}/block"] = attention.attention_block(params, spec, x,
                                                          pos)
            kv = attention.init_kv_cache(B, spec, GEMMA_PIECE_LEN + 4,
                                         jnp.float32)
            y, kv = attention.prefill_attention(params, spec, x, pos, kv)
            out.update({f"{p}/prefill": y, f"{p}/prefill_k": kv["k"],
                        f"{p}/prefill_v": kv["v"]})
            # row 0 appends at position 100, row 1 at 103: on the sliding
            # ring, slots 36 and 39, over prompt positions 36 and 39
            x1 = normal(B, 1, d)
            dpos = np.array([GEMMA_PIECE_LEN, GEMMA_PIECE_LEN + 3], np.int32)
            y, kv = attention.decode_attention(params, spec, x1, kv,
                                               jnp.asarray(dpos))
            out.update({f"{p}/decode_x": x1, f"{p}/decode_pos": dpos,
                        f"{p}/decode": y, f"{p}/decode_k": kv["k"],
                        f"{p}/decode_v": kv["v"]})

    model_rng = np.random.default_rng(9)
    for name, cfg in (("gemma2", dataclasses.replace(smoke, num_layers=2)),
                      ("gemma8", dataclasses.replace(smoke, num_layers=8)),
                      ("gemma2_hd256", dataclasses.replace(
                          smoke, num_layers=2, head_dim=256))):
        dump_model(out, transformer, ServeEngine, cfg, name,
                   400 + len(name) + cfg.num_layers, model_rng,
                   prompt=GEMMA_PROMPT, fwd_len=GEMMA_PROMPT,
                   max_len=GEMMA_MAX_LEN)
    tiny = dataclasses.replace(get_config("gemma3-4b"), **GEMMA_TINY)
    dump_model(out, transformer, ServeEngine, tiny, "gemma34", 434,
               model_rng, prompt=GEMMA_TINY_PROMPT,
               fwd_len=GEMMA_TINY_PROMPT, max_len=GEMMA_TINY_MAX_LEN)
    return {key: np.asarray(a) for key, a in out.items()}


# the replica step: N agents, one 64-token sequence each, 3 steps; the
# NetES constants; the run's three modes (family, representation, channel)
NETES_N, NETES_SEQ, NETES_STEPS = 4, 64, 3
NETES_ARCHS = ("gemma3-4b-smoke", "moonshot-v1-16b-a3b-smoke",
               "whisper-tiny-smoke")
NETES_CFG = dict(alpha=0.01, sigma=0.02, p_broadcast=0.5,
                 weight_decay=0.005)
NETES_CHANNEL = "quantize(bits=8)|dropout(p=0.1,seed=0)"
NETES_MODES = {"fc": ("fully_connected", "dense", None),
               "er": ("erdos_renyi", "sparse", None),
               "chan": ("erdos_renyi", "sparse", NETES_CHANNEL)}
# the broadcast pattern of the 3 steps (no, yes, no), so that step 1
# holds the mixing alone and step 2 the broadcast
NETES_BCAST = (False, True, False)
XENT_CHUNK = 16


def import_netes():
    saved = batching.primitive_batchers
    batching.primitive_batchers = {optimization_barrier_p: None}
    try:
        from repro.comm import channel
        from repro.core import topology, topology_repr
        from repro.core.netes import NetESConfig
        from repro.data import make_batch
        from repro.distributed import netes_dist
    finally:
        batching.primitive_batchers = saved
    return channel, topology, topology_repr, NetESConfig, make_batch, \
        netes_dist


def dump_netes(transformer, archs=NETES_ARCHS):
    """Per arch, under ``<arch>/``: ``params`` (one agent's: every agent
    starts from it), ``tokens<t>`` (N, 1, S) and the draws of step t:
    ``beta<t>`` and ``eps<t>/<agent>/...`` (ε of each leaf, per stacked
    slice as the reference's noise contract folds it, generated by its own
    ``perturb_params`` at σ = 1 from zeros); ``loss`` and ``loss_chunked``
    (``loss_fn`` of agent 0's θ on step 0's first sequence, whole and in
    chunks of ``XENT_CHUNK``); per mode ``<mode>/adj`` (and for a sparse
    mode its ``neighbor_idx``/``neighbor_mask``), the metrics of each step
    ``<mode>/metrics<t>/<name>``, a channel's dropout masks
    ``<mode>/edge_mask<t>``, and the parameters after steps 1, 3 (and for
    the channel 2) ``<mode>/after<k>/...`` with the agent axis leading.
    The step keys are ``fold_in(PRNGKey(seed), t)`` for the first seed
    whose broadcast draws give ``NETES_BCAST``. Only ``archs`` are
    dumped."""
    channel, topology, topology_repr, NetESConfig, make_batch, netes_dist = \
        import_netes()
    ncfg = NetESConfig(**NETES_CFG)
    n = NETES_N
    seed = next(s for s in range(100) if tuple(
        bool(jax.random.uniform(jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(s), t))[1])
             < ncfg.p_broadcast) for t in range(NETES_STEPS)) == NETES_BCAST)
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), t)
            for t in range(NETES_STEPS)]
    out = {}
    for a, arch in enumerate(NETES_ARCHS):
        if arch not in archs:
            continue
        cfg = get_config(arch)
        p0 = transformer.init_params(jax.random.PRNGKey(500 + a), cfg,
                                     jnp.float32)
        out.update(flatten(p0, f"{arch}/params"))
        params = jax.tree.map(
            lambda l: jnp.broadcast_to(l, (n,) + l.shape).copy(), p0)
        zeros = jax.tree.map(jnp.zeros_like, p0)
        batch_fn = jax.jit(lambda k, cfg=cfg: make_batch(
            cfg, dict(seq_len=NETES_SEQ, global_batch=n), k))
        eps_fn = jax.jit(lambda k, zeros=zeros: netes_dist.perturb_params(
            zeros, k, 1.0, 1.0))
        batches = []
        for t, key in enumerate(keys):
            b = batch_fn(jax.random.fold_in(jax.random.PRNGKey(700 + a), t))
            b = jax.tree.map(lambda x: x.reshape((n, 1) + x.shape[1:]), b)
            batches.append(b)
            out[f"{arch}/tokens{t}"] = b["tokens"]
            if "frames" in b:
                out[f"{arch}/frames{t}"] = b["frames"]
            k_agents, k_beta = jax.random.split(key)
            out[f"{arch}/beta{t}"] = jax.random.uniform(k_beta)
            for i in range(n):
                out.update(flatten(eps_fn(jax.random.fold_in(k_agents, i)),
                                   f"{arch}/eps{t}/{i}"))
        first = {k: v[0] for k, v in batches[0].items()}
        out[f"{arch}/loss"] = transformer.loss_fn(p0, cfg, first)
        out[f"{arch}/loss_chunked"] = transformer.loss_fn(
            p0, cfg, first, xent_chunk=XENT_CHUNK)
        for mode, (family, rep, chan_text) in NETES_MODES.items():
            adj = np.asarray(topology.make_topology(family, n, p=0.5, seed=0),
                             np.float32)
            topo = topology_repr.from_dense(adj, rep)
            out[f"{arch}/{mode}/adj"] = adj
            if rep == "sparse":
                out[f"{arch}/{mode}/neighbor_idx"] = topo.neighbor_idx
                out[f"{arch}/{mode}/neighbor_mask"] = topo.neighbor_mask
            chan = (channel.compile_channel(chan_text, n) if chan_text
                    else None)
            step = jax.jit(netes_dist.make_replica_train_step(
                cfg, ncfg, n, microbatch=1, topology=topo, channel=chan))
            p = params
            cstate = chan.init(p) if chan is not None else None
            for t, key in enumerate(keys):
                if chan is not None:
                    # the step's own dropout draw, made again
                    _, sub = jax.random.split(cstate.key)
                    out[f"{arch}/{mode}/edge_mask{t}"] = channel.dropout_mask(
                        sub, topo, chan.dropout_stage.p)
                    p, metrics, cstate = step(p, None, batches[t], key,
                                              cstate)
                else:
                    p, metrics = step(p, None, batches[t], key)
                out.update(flatten(metrics, f"{arch}/{mode}/metrics{t}"))
                if t + 1 in ((1, 2, 3) if chan is not None else (1, 3)):
                    out.update(flatten(p, f"{arch}/{mode}/after{t + 1}"))
    return {key: np.asarray(v) for key, v in out.items()}


# the llama4 pieces: qk-norm attention of the smokes' widths (d 256, 4/2
# heads of 64) on the smoke's chunked layer (chunk 64) and its global one,
# over a 192-token input; prefill of 192 tokens (the end of a chunk) and of
# 176 (inside one), each followed by two decode steps at P and P + 1 (at
# P = 192 the first position of a new chunk, then inside it)
LLAMA_PIECE_LEN = 192
LLAMA_PIECE_PROMPTS = (192, 176)
LLAMA_KINDS = {"chunked": 0, "global": 1}     # layer of the smoke config
# the MoE layer at top-1: (E, d, d_ff, group, tokens per row) — E = 16
# and 128 over two groups of 64 a row, and E = 128 over one token a row
# (decode's group of one, one slot an expert)
LLAMA_MOE = {"e16": (16, 64, 128, 64, 128), "e128": (128, 64, 128, 64, 128),
             "e128_decode": (128, 64, 128, 512, 1)}
# the smoke models: prompts and a forward of 192 tokens (three chunks of
# 64, three MoE groups of 64) and a cache of 200 positions
LLAMA_SMOKES = {"scout": "llama4-scout-17b-a16e-smoke",
                "maverick": "llama4-maverick-400b-a17b-smoke"}
LLAMA_PROMPT, LLAMA_MAX_LEN = 192, 200
# 48-layer models of the full configs' patterns at tiny widths, chunk 8,
# MoE groups of 16: 16-token prompts cross a chunk boundary. d_ff is 16:
# the reference draws the experts with fan-in E (1/4 at E = 16, twice the
# dense layers' 1/√32), and at d_ff 64 scout's 48 MoE layers grow float32
# rounding past 2e-5 in the deepest caches (≈ 5e-5 at layer 43, the two
# packages alike); at 16 it stays ≈ 1e-5
LLAMA_TINY = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                  d_ff=16, vocab_size=64, chunk_size=8, moe_group_size=16)
LLAMA_FULL = {"scout48": "llama4-scout-17b-a16e",
              "maverick48": "llama4-maverick-400b-a17b"}
LLAMA_TINY_PROMPT, LLAMA_TINY_MAX_LEN = 16, 24


def dump_llama4(attention, moe, transformer, ServeEngine):
    rng = np.random.default_rng(10)
    out = {}
    scout = get_config(LLAMA_SMOKES["scout"])
    d = scout.d_model

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for kind, layer in LLAMA_KINDS.items():
        p = f"attn_{kind}"
        spec = transformer.attn_spec(scout, scout.layer_specs()[layer])
        params = dict(attention.attn_init(jax.random.PRNGKey(600 + layer), d,
                                          spec, jnp.float32))
        # away from the init's ones, so that the scales move the output
        params["q_norm"] = {"scale": 1 + normal(spec.head_dim, scale=0.3)}
        params["k_norm"] = {"scale": 1 + normal(spec.head_dim, scale=0.3)}
        out.update(flatten(params, f"{p}/params"))
        x = normal(B, LLAMA_PIECE_LEN, d)
        out[f"{p}/x"] = x
        out[f"{p}/block"] = attention.attention_block(
            params, spec, x, jnp.arange(LLAMA_PIECE_LEN))
        for s in LLAMA_PIECE_PROMPTS:
            q = f"{p}/p{s}"
            kv = attention.init_kv_cache(B, spec, s + 8, jnp.float32)
            y, kv = attention.prefill_attention(params, spec, x[:, :s],
                                                jnp.arange(s), kv)
            out.update({f"{q}/prefill": y, f"{q}/prefill_k": kv["k"],
                        f"{q}/prefill_v": kv["v"]})
            for step in range(2):
                x1 = normal(B, 1, d)
                pos = jnp.full((B,), s + step, jnp.int32)
                y, kv = attention.decode_attention(params, spec, x1, kv, pos)
                out.update({f"{q}/decode{step}_x": x1,
                            f"{q}/decode{step}": y,
                            f"{q}/decode{step}_k": kv["k"],
                            f"{q}/decode{step}_v": kv["v"]})

    for name, (e, dm, ff, group, s) in LLAMA_MOE.items():
        spec = moe.MoESpec(num_experts=e, experts_per_token=1, d_model=dm,
                           d_ff=ff, group_size=group)
        params = moe.moe_init(jax.random.PRNGKey(700 + len(name) + e), spec,
                              jnp.float32)
        out.update(flatten(params, f"{name}/params"))
        x = normal(B, s, dm)
        logits = jnp.asarray(x).reshape(-1, dm) @ params["router"]
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 1)
        out.update({f"{name}/x": x, f"{name}/ids": ids,
                    f"{name}/moe_block": moe.moe_block(params, spec, x)})

    model_rng = np.random.default_rng(11)
    for i, (name, arch) in enumerate(LLAMA_SMOKES.items()):
        dump_model(out, transformer, ServeEngine, get_config(arch), name,
                   800 + i, model_rng, prompt=LLAMA_PROMPT,
                   fwd_len=LLAMA_PROMPT, max_len=LLAMA_MAX_LEN)
    for i, (name, arch) in enumerate(LLAMA_FULL.items()):
        tiny = dataclasses.replace(get_config(arch), **LLAMA_TINY)
        dump_model(out, transformer, ServeEngine, tiny, name, 848 + i,
                   model_rng, prompt=LLAMA_TINY_PROMPT,
                   fwd_len=LLAMA_TINY_PROMPT, max_len=LLAMA_TINY_MAX_LEN)
    return {key: np.asarray(a) for key, a in out.items()}


# the frontends part: cross attention (Sq 10 over 24 keys) and non-causal
# self attention pieces of whisper-tiny-smoke's widths (4 heads of 32, no
# RoPE) and of llava-next-mistral-7b-smoke's (4/2 heads of 64, RoPE);
# whisper-tiny-smoke with 64 frames (its encoder_seq) at 2 decoder layers
# (unrolled) and 4 (scanned as plan (0, 1, 4, 0)); llava-next-mistral-7b-
# smoke with 16 patches, its forward and generate with the patches (which
# the reference's serving drops), and its loss_fn over the patches and 10
# tokens (one chunk) and 32 tokens (chunks of 16)
CROSS_SQ, CROSS_SK = 10, 24
FRONT_ARCHS = {"whisper": "whisper-tiny-smoke",
               "llava": "llava-next-mistral-7b-smoke"}
WHISPER_LAYERS = (2, 4)
LLAVA_LOSS_LENS, LLAVA_XENT_CHUNK = (10, 32), 16


def dump_frontends(attention, transformer, ServeEngine):
    from repro.configs import LayerSpec
    rng = np.random.default_rng(12)
    out = {}

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for name, arch in FRONT_ARCHS.items():
        cfg = get_config(arch)
        d = cfg.d_model
        spec = transformer.attn_spec(cfg, LayerSpec("attn_full", "swiglu"))
        params = attention.attn_init(jax.random.PRNGKey(900 + len(name)), d,
                                     spec, jnp.float32)
        out.update(flatten(params, f"attn_{name}/params"))
        x, kv = normal(B, CROSS_SQ, d), normal(B, CROSS_SK, d)
        out.update({f"attn_{name}/x": x, f"attn_{name}/kv_x": kv})
        out[f"attn_{name}/cross"] = attention.attention_block(
            params, spec, x, jnp.arange(CROSS_SQ), kv_x=kv,
            kv_positions=jnp.arange(CROSS_SK), causal=False)
        out[f"attn_{name}/noncausal"] = attention.attention_block(
            params, spec, kv, jnp.arange(CROSS_SK), causal=False)

    whisper = get_config(FRONT_ARCHS["whisper"])
    for n_layers in WHISPER_LAYERS:
        cfg = dataclasses.replace(whisper, num_layers=n_layers)
        frames = normal(B, cfg.encoder_seq, cfg.d_model, scale=0.02)
        out[f"whisper{n_layers}/frames"] = frames
        dump_model(out, transformer, ServeEngine, cfg, f"whisper{n_layers}",
                   950 + n_layers, rng, extra={"frames": frames})

    llava = get_config(FRONT_ARCHS["llava"])
    patches = normal(B, llava.num_patches, llava.d_model, scale=0.02)
    out["llava/patch_embeds"] = patches
    params = dump_model(out, transformer, ServeEngine, llava, "llava", 960,
                        rng, extra={"patch_embeds": patches})
    for s in LLAVA_LOSS_LENS:
        tokens = rng.integers(0, llava.vocab_size, (B, s)).astype(np.int32)
        batch = {"tokens": tokens, "labels": tokens, "patch_embeds": patches}
        out[f"llava/loss{s}_tokens"] = tokens
        out[f"llava/loss{s}"] = transformer.loss_fn(
            params, llava, batch, xent_chunk=LLAVA_XENT_CHUNK)
    return {key: np.asarray(a) for key, a in out.items()}


# the consensus step (``make_consensus_train_step``): P = 4 members, one
# 64-token sequence each, 3 steps; the archs (maverick-smoke on the
# runtime adjacency only) and the variants: the runtime ``adj`` (ER p =
# 0.5), the same graph as a sparse ``Topology``, a ``resample_er``
# schedule redrawn at every step over that graph, and the Topology through
# channel (a); the steps after which the parameters are dumped
CONS_N, CONS_SEQ, CONS_STEPS = 4, 64, 3
CONS_ARCHS = ("llama4-scout-17b-a16e-smoke", "jamba-v0.1-52b-smoke",
              "gemma3-4b-smoke", "llama4-maverick-400b-a17b-smoke")
CONS_ADJ_ONLY = ("llama4-maverick-400b-a17b-smoke",)
CONS_SCHEDULE = "resample_er(period=1)"
CONS_AFTER = {"adj": (1, 3), "topo": (3,), "sched": (3,), "chan": (1, 2, 3)}
# θ⁽⁰⁾'s key is the first from 800 + 20·(the arch's index) whose step-0
# rewards (the reference's) lie at least this far apart, so that float32
# rounding cannot reorder them (a step's update moves the later steps'
# rewards much further apart)
CONS_STEP0_GAP = 1e-4


def import_consensus():
    saved = batching.primitive_batchers
    batching.primitive_batchers = {optimization_barrier_p: None}
    try:
        from repro.comm import channel
        from repro.core import topology, topology_repr, topology_sched
        from repro.core.netes import NetESConfig
        from repro.core.topology import TopologySpec
        from repro.data import make_batch
        from repro.distributed import netes_dist
    finally:
        batching.primitive_batchers = saved
    return (channel, topology, topology_repr, topology_sched, NetESConfig,
            TopologySpec, make_batch, netes_dist)


def dump_consensus(transformer, archs=CONS_ARCHS):
    """Per arch, under ``<arch>/``: ``params`` (θ⁽⁰⁾, from ``init_key``,
    see ``CONS_STEP0_GAP``), ``tokens<t>`` (P,
    1, S), ``k_agents<t>`` (the members' key of step t: member i's ε is
    ``perturb_params`` from ``fold_in(k_agents, i)``), ``beta<t>``,
    ``leaf_keys`` (the parameter tree's leaves in its flatten order, the
    order the noise contract numbers them), ``eps0/0/...`` (member 0's ε
    of step 0, made by the reference's ``perturb_params`` at σ = 1 from
    zeros); per variant ``<variant>/metrics<t>/<name>``, the channel's
    dropout masks ``chan/edge_mask<t>``, the schedule's uniforms
    ``sched/u<t>`` (the redraw of the advance after step t), and the
    parameters after the steps of ``CONS_AFTER``, ``<variant>/after<k>/
    ...``. The graph is ``adj`` (ER p = 0.5, seed 0, dense) or its sparse
    ``Topology``; the step keys are the ``netes`` part's, for the
    broadcast pattern ``NETES_BCAST``. Only ``archs`` are dumped; the
    graph's keys always are."""
    (channel, topology, topology_repr, topology_sched, NetESConfig,
     TopologySpec, make_batch, netes_dist) = import_consensus()
    ncfg = NetESConfig(**NETES_CFG)
    n = CONS_N
    seed = next(s for s in range(100) if tuple(
        bool(jax.random.uniform(jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(s), t))[1])
             < ncfg.p_broadcast) for t in range(CONS_STEPS)) == NETES_BCAST)
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), t)
            for t in range(CONS_STEPS)]
    base = TopologySpec(family="erdos_renyi", n_agents=n, p=0.5, seed=0)
    adj = np.asarray(base.build(), np.float32)
    topo = topology_repr.from_dense(adj, "sparse")
    out = {"adj": adj, "neighbor_idx": topo.neighbor_idx,
           "neighbor_mask": topo.neighbor_mask}
    for a, arch in enumerate(CONS_ARCHS):
        if arch not in archs:
            continue
        cfg = get_config(arch)
        batch_fn = jax.jit(lambda k, cfg=cfg: make_batch(
            cfg, dict(seq_len=CONS_SEQ, global_batch=n), k))
        batches = [jax.tree.map(
            lambda x: x.reshape((n, 1) + x.shape[1:]),
            batch_fn(jax.random.fold_in(jax.random.PRNGKey(900 + a), t)))
            for t in range(CONS_STEPS)]
        k0 = jax.random.split(keys[0])[0]

        @jax.jit
        def rewards(p0, i, cfg=cfg, b0=batches[0], k0=k0):
            pert = netes_dist.perturb_params(p0, jax.random.fold_in(k0, i),
                                             ncfg.sigma, 1.0)
            mb = jax.tree.map(lambda x: x[i], b0)
            neg = jax.tree.map(lambda t, q: 2.0 * t - q, p0, pert)
            return jnp.stack([-transformer.loss_fn(pert, cfg, mb),
                              -transformer.loss_fn(neg, cfg, mb)])

        for init in range(800 + 20 * a, 820 + 20 * a):
            p0 = transformer.init_params(jax.random.PRNGKey(init), cfg,
                                         jnp.float32)
            raw = np.sort(np.concatenate([np.asarray(rewards(p0, i))
                                          for i in range(n)]))
            if np.diff(raw).min() > CONS_STEP0_GAP:
                break
        else:
            raise RuntimeError(f"{arch}: no θ⁽⁰⁾ with step 0's rewards "
                               f"{CONS_STEP0_GAP} apart")
        out[f"{arch}/init_key"] = np.int32(init)
        out.update(flatten(p0, f"{arch}/params"))
        paths = jax.tree_util.tree_flatten_with_path(p0)[0]
        out[f"{arch}/leaf_keys"] = np.array([
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in paths])
        zeros = jax.tree.map(jnp.zeros_like, p0)
        for t, key in enumerate(keys):
            out[f"{arch}/tokens{t}"] = batches[t]["tokens"]
            k_agents, k_beta = jax.random.split(key)
            out[f"{arch}/k_agents{t}"] = k_agents
            out[f"{arch}/beta{t}"] = jax.random.uniform(k_beta)
            if t == 0:
                out.update(flatten(netes_dist.perturb_params(
                    zeros, jax.random.fold_in(k_agents, 0), 1.0, 1.0),
                    f"{arch}/eps0/0"))
        variants = ("adj",) if arch in CONS_ADJ_ONLY else tuple(CONS_AFTER)
        for variant in variants:
            sched = chan = None
            if variant == "sched":
                sched = topology_sched.compile_schedule(
                    topology_sched.ScheduleSpec.parse(CONS_SCHEDULE), base)
            if variant == "chan":
                chan = channel.compile_channel(NETES_CHANNEL, n)
            step = jax.jit(netes_dist.make_consensus_train_step(
                cfg, ncfg, n, topology=topo if variant in ("topo", "chan")
                else None, schedule=sched, channel=chan))
            p = p0
            sstate = sched.init() if sched is not None else None
            cstate = chan.init(p) if chan is not None else None
            pre = f"{arch}/{variant}"
            for t, key in enumerate(keys):
                if variant == "sched":
                    out[f"{pre}/u{t}"] = jax.random.uniform(
                        jax.random.split(sstate.key)[1], (n, n))
                    p, metrics, sstate = step(p, None, batches[t], key,
                                              sstate)
                elif variant == "chan":
                    _, sub = jax.random.split(cstate.key)
                    out[f"{pre}/edge_mask{t}"] = channel.dropout_mask(
                        sub, topo, chan.dropout_stage.p)
                    p, metrics, cstate = step(p, None, batches[t], key,
                                              cstate)
                else:
                    p, metrics = step(p, jnp.asarray(adj), batches[t], key)
                out.update(flatten(metrics, f"{pre}/metrics{t}"))
                if variant == "chan":
                    out[f"{pre}/chan_msgs{t}"] = cstate.msgs
                if t + 1 in CONS_AFTER[variant]:
                    out.update(flatten(p, f"{pre}/after{t + 1}"))
    return {key: np.asarray(v) for key, v in out.items()}


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def _specs_json(tree):
    from jax.sharding import PartitionSpec
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _spec_json(s) for path, s in leaves}


def _shapes_json(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): [list(x.shape), str(x.dtype)]
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# the cache specs' batch sizes (B = 1: the sequence over every axis)
SHARD_CACHE_BATCHES = (1, 128)
SHARD_CACHE_LEN = 32768


def dump_sharding():
    """The reference's placement on its two production meshes (16 × 16
    and 2 × 16 × 16; the process runs with 512 forced host devices), by
    mesh name: ``params`` (arch → mode → key → spec; replica over the
    agent-stacked abstract tree), ``cache`` (arch → B → key → spec),
    ``roles`` (arch → mode → kind → role → spec), ``classify`` ("arch
    shape" → [mode, kind, n_agents]) and ``inputs`` ("arch shape" →
    ``args`` key → [shape, dtype] and ``specs`` key → spec), for every
    pair of ``shape_pairs()``. A spec is a list of None, an axis name, or
    a list of names."""
    saved = batching.primitive_batchers
    batching.primitive_batchers = {optimization_barrier_p: None}
    try:
        from repro.configs import ASSIGNED_ARCHS, shape_pairs
        from repro.distributed import sharding
        from repro.launch import specs
        from repro.launch.mesh import make_production_mesh
    finally:
        batching.primitive_batchers = saved
    out = {}
    for name, mesh in (("single", make_production_mesh()),
                       ("multi", make_production_mesh(multi_pod=True))):
        res = {"params": {}, "cache": {}, "roles": {}, "classify": {},
               "inputs": {}}
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            abstract = specs.abstract_params(cfg)
            res["params"][arch] = {
                mode: _specs_json(sharding.param_pspecs(
                    cfg, specs.stack_abstract(abstract, sharding.n_agents(
                        mesh)) if mode == "replica" else abstract, mode,
                    mesh))
                for mode in ("replica", "consensus", "serve")}
            res["cache"][arch] = {
                str(b): _specs_json(sharding.cache_pspecs(
                    cfg, specs.abstract_cache(cfg, b, SHARD_CACHE_LEN), mesh,
                    b)) for b in SHARD_CACHE_BATCHES}
            res["roles"][arch] = {
                mode: {kind: {r: _spec_json(s) for r, s in
                              sharding.activation_roles(cfg, mode, mesh,
                                                        kind).items()}
                       for kind in ("train", "prefill", "decode")}
                for mode in ("replica", "consensus", "serve")}
        for arch, shape in shape_pairs():
            pair = specs.classify(arch, shape, mesh)
            res["classify"][f"{arch} {shape}"] = [pair.mode, pair.kind,
                                                  pair.n_agents]
            info = specs.input_specs(arch, shape, mesh)
            res["inputs"][f"{arch} {shape}"] = {
                "args": _shapes_json(info["args"]),
                "specs": _specs_json(info["specs"])}
        out[name] = res
    return out


# the dry run's smoke pairs on a mesh of one: (arch, shape, consensus),
# at the smoke shapes below (``INPUT_SHAPES`` gains them for the run)
DRYRUN_SHAPES = {
    "train_smoke": dict(seq_len=64, global_batch=2, kind="train"),
    "prefill_smoke": dict(seq_len=64, global_batch=2, kind="prefill"),
    "decode_smoke": dict(seq_len=64, global_batch=2, kind="decode"),
}
DRYRUN_CASES = (
    ("mistral-nemo-12b-smoke", "train_smoke", False),
    ("mistral-nemo-12b-smoke", "prefill_smoke", False),
    ("mistral-nemo-12b-smoke", "decode_smoke", False),
    ("llama4-scout-17b-a16e-smoke", "train_smoke", True),
)


def dump_dryrun():
    """``hlo_parse.hlo_costs`` of the reference's compiled step for each
    of ``DRYRUN_CASES`` on a mesh of one device ("data", "model" of size
    1), the smoke shapes added to ``INPUT_SHAPES`` and, for a consensus
    case, the arch to ``CONSENSUS_ARCHS``: ``{"shapes": ..., "cases":
    [{"arch", "shape", "consensus", "mode", "hlo_costs"}]}``."""
    saved = batching.primitive_batchers
    batching.primitive_batchers = {optimization_barrier_p: None}
    try:
        from repro.configs import INPUT_SHAPES
        from repro.launch import hlo_parse, specs
    finally:
        batching.primitive_batchers = saved
    from jax.sharding import Mesh
    INPUT_SHAPES.update(DRYRUN_SHAPES)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    cases = []
    for arch, shape, consensus in DRYRUN_CASES:
        saved_archs = specs.CONSENSUS_ARCHS
        if consensus:
            specs.CONSENSUS_ARCHS = saved_archs + (arch,)
        try:
            lowered, pair = specs.lower_pair(arch, shape, mesh)
            costs = hlo_parse.hlo_costs(lowered.compile().as_text())
        finally:
            specs.CONSENSUS_ARCHS = saved_archs
        cases.append({"arch": arch, "shape": shape, "consensus": consensus,
                      "mode": pair.mode, "n_agents": pair.n_agents,
                      "hlo_costs": {k: float(v) for k, v in costs.items()}})
    return {"shapes": DRYRUN_SHAPES, "cases": cases}


# the blockwise part: ``blockwise_attention`` at q_block 40 and k_block 48
# (Sq > q_block and Sk > k_block, neither a multiple where the pattern
# masks padded keys; Sk a multiple where it does not: non-causal self and
# cross attention), for G = 1 and 2 and head_dim 32 and 64; (label, kind,
# window, causal, Sq, Sk)
BW_Q_BLOCK, BW_K_BLOCK = 40, 48
BW_PATTERNS = (
    ("full", "full", 0, True, 100, 100),
    ("sliding", "sliding", 24, True, 100, 100),
    ("chunked", "chunked", 40, True, 100, 100),
    ("noncausal", "full", 0, False, 100, 96),
    ("cross", "full", 0, False, 70, 144),
)
BW_G = (1, 2)
BW_HEAD_DIMS = (32, 64)
BW_HKV = 2
# ``attention_block`` (its default blocks of 512 queries and 1024 keys) at
# 1100 positions, d_model 64, 4/2 heads of 32: full causal and sliding
BW_BLOCK_SEQ, BW_BLOCK_D = 1100, 64
BW_BLOCK_KINDS = (("full", 0), ("sliding", 300))
# fault i: non-causal over 1500 keys (k_block 1024, 548 padded keys)
BW_FAULT_SEQ = 1500
# es_step: sphere, N = 16 agents, D = 12, three steps
ES_N, ES_D, ES_STEPS = 16, 12, 3


def dump_blockwise(attention):
    from repro.core import netes
    from repro.envs.landscapes import make_landscape_reward_fn
    rng = np.random.default_rng(31)
    out = {}

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    for label, kind, window, causal, sq, sk in BW_PATTERNS:
        for g in BW_G:
            for hd in BW_HEAD_DIMS:
                p = f"bw_{label}_g{g}_hd{hd}"
                spec = attention.AttnSpec(num_heads=BW_HKV * g,
                                          num_kv_heads=BW_HKV, head_dim=hd,
                                          kind=kind, window=window)
                q = normal(B, sq, BW_HKV * g, hd)
                k, v = normal(B, sk, BW_HKV, hd), normal(B, sk, BW_HKV, hd)
                out.update({f"{p}/q": q, f"{p}/k": k, f"{p}/v": v})
                out[f"{p}/out"] = attention.blockwise_attention(
                    spec, q, k, v, jnp.arange(sq), jnp.arange(sk),
                    causal=causal, q_block=BW_Q_BLOCK, k_block=BW_K_BLOCK)

    for kind, window in BW_BLOCK_KINDS:
        p = f"block_{kind}"
        spec = attention.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=32,
                                  kind=kind, window=window)
        params = attention.attn_init(jax.random.PRNGKey(70 + window),
                                     BW_BLOCK_D, spec, jnp.float32)
        out.update(flatten(params, f"{p}/params"))
        x = normal(1, BW_BLOCK_SEQ, BW_BLOCK_D)
        out[f"{p}/x"] = x
        out[f"{p}/out"] = attention.attention_block(
            params, spec, x, jnp.arange(BW_BLOCK_SEQ))

    spec = attention.AttnSpec(num_heads=2, num_kv_heads=2, head_dim=32)
    q, k = normal(1, BW_FAULT_SEQ, 2, 32), normal(1, BW_FAULT_SEQ, 2, 32)
    # values of mean 3 (|out| ≈ 3): the softmax mass the 548 zero keys
    # take shows as a shift of the output
    v = normal(1, BW_FAULT_SEQ, 2, 32) + np.float32(3.0)
    out.update({"fault_i/q": q, "fault_i/k": k, "fault_i/v": v})
    pos = jnp.arange(BW_FAULT_SEQ)
    out["fault_i/out"] = attention.blockwise_attention(spec, q, k, v, pos,
                                                       pos, causal=False)

    reward_fn = make_landscape_reward_fn("sphere")
    cfg = netes.NetESConfig(alpha=0.05, sigma=0.1)
    theta = jnp.asarray(normal(ES_D))
    key = jax.random.PRNGKey(5)
    out["es/theta0"] = theta
    for t in range(ES_STEPS):
        # es_step's own draw: split(key, 3), ε from the second key
        eps = jax.random.normal(jax.random.split(key, 3)[1],
                                (ES_N, ES_D), dtype=theta.dtype)
        theta, key, m = netes.es_step(theta, key, reward_fn, cfg, ES_N)
        out.update({f"es/eps{t}": eps, f"es/theta{t + 1}": theta,
                    f"es/reward_mean{t}": m["reward_mean"],
                    f"es/reward_max{t}": m["reward_max"]})
    return {key: np.asarray(a) for key, a in out.items()}


if __name__ == "__main__":
    main(*sys.argv[1:])
