"""The JAX reference's LM outputs for the port's tests, dumped to an npz.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_lm_ref.py OUT.npz

``repro.models`` does not import on this jax (ROADMAP queue 3, item a):
``models/attention.py:172`` asks ``prim in batching.primitive_batchers``,
and that attribute is now a proxy that does not support ``in``. For the
length of the import only, this script puts a plain dict holding the
barrier primitive in its place, so the reference registers no rule of its
own, then restores the proxy. No file of the reference changes. It runs
in a process of its own (``tests/test_torch_lm.py`` starts it), so no
other test module ever sees the swap.

Everything is drawn from fixed seeds: the weights with the reference's own
``init_params`` (mistral-nemo-12b-smoke at 2 layers, unrolled, and at 4
layers, scanned), the inputs with numpy. Keys are "/"-joined paths.
"""
import dataclasses
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
        from repro.models import attention, layers, transformer
        from repro.serve import ServeEngine
    finally:
        batching.primitive_batchers = saved
    return attention, layers, transformer, ServeEngine


def flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix, *parts])] = np.asarray(leaf)
    return out


def main(path):
    attention, layers, transformer, ServeEngine = import_reference()
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
        params = transformer.init_params(jax.random.PRNGKey(n_layers), cfg,
                                         jnp.float32)
        p = f"p{n_layers}"
        out.update(flatten(params, f"{p}/params"))
        tokens = rng.integers(0, v, (B, FWD_LEN)).astype(np.int32)
        out[f"{p}/forward_tokens"] = tokens
        out[f"{p}/forward_logits"] = transformer.forward(
            params, cfg, {"tokens": tokens})
        prompts = rng.integers(0, v, (B, PROMPT)).astype(np.int32)
        cache = transformer.init_cache(cfg, B, MAX_LEN, jnp.float32)
        last, cache = transformer.prefill(params, cfg, {"tokens": prompts},
                                          cache)
        out.update({f"{p}/prompts": prompts, f"{p}/prefill_logits": last})
        out.update(flatten(cache, f"{p}/prefill_cache"))
        steps = rng.integers(0, v, (B, STEPS)).astype(np.int32)
        logits = []
        for i in range(STEPS):
            lg, cache = transformer.decode_step(
                params, cfg, steps[:, i:i + 1], cache,
                jnp.full((B,), PROMPT + i, jnp.int32))
            logits.append(np.asarray(lg))
        out.update({f"{p}/decode_tokens": steps,
                    f"{p}/decode_logits": np.stack(logits)})
        out.update(flatten(cache, f"{p}/decode_cache"))
        engine = ServeEngine(cfg, params, max_len=MAX_LEN)
        out[f"{p}/generate_tokens"] = engine.generate(jnp.asarray(prompts),
                                                      new_tokens=NEW)
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
    np.savez(path, **{k: np.asarray(a) for k, a in out.items()})


if __name__ == "__main__":
    main(sys.argv[1])
