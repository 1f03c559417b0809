"""The port's llama4 slice (chunked-local attention with a global layer
every 4th, qk-norm, top-1 MoE at E = 16 on every layer (scout) or E = 128
on every other layer (maverick)) against the JAX reference's
``repro.models``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``llama4`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: qk-norm attention pieces of the smokes' widths on the smoke's
chunked layer (chunk 64) and its global layer, with q_norm and k_norm
scales moved away from the init's ones (``attention_block`` over 192
tokens; ``prefill_attention`` of 192 tokens, the end of the third chunk,
and of 176, inside it, each with its cache; two ``decode_attention`` steps
after each, at 192 the first position of a new chunk and then inside it);
the MoE layer at top-1 with E = 16 and 128 (two groups of 64 a row) and
with E = 128 over one token a row (decode's group of one: one slot an
expert), with the reference's router ids; and whole models with the
reference's own weights: llama4-scout-17b-a16e-smoke and
llama4-maverick-400b-a17b-smoke (unrolled: a chunked layer, then a global
one) with a 192-token forward, a 192-token prefill with its cache (three
chunks, three MoE groups), 4 decode steps with their cache and greedy
``generate``; and a 48-layer model of each full config's pattern at tiny
widths (plan (0, 4, 12, 0): 3 chunked layers and a global one, stacked
12 times; chunk 8 and 16-token prompts). The port takes those weights
through ``convert.lm_params_from_reference`` and runs on the CPU, where
the flash kernel's and the router's wrappers run their plain versions.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in other
orders, ≈ 1e-6 at these widths; a missing chunk mask, a ring slot off by
one or a layer out of order moves the outputs by ≥ 1e-3. Greedy tokens
and router ids are held EQUAL. A top-1 router routes as the reference's
only away from near-ties, so each MoE layer the models call asserts that
its tokens' smallest gap between the first and second probability is
above ``MIN_MARGIN`` = 1e-5, 100× the packages' rounding of a float32
probability (≈ 1e-7), as ``tests/test_torch_mamba.py`` does; the MoE
layer pieces, whose 256 tokens at E = 128 hold closer pairs, assert the
router test's bound instead: a gap above 1e-6 of the larger probability
(8 float32 ulps). The 48-layer models route ≈ 1,500 tokens through 24–48
layers at tiny widths, where gaps of 3e-6–8e-6 occur; they assert gaps
above ``MIN_MARGIN_DEEP`` = 1e-6. That bound alone does not rule out a
flip after 48 layers of rounding (≈ 3e-6 relative in the residual); what
shows that every top-1 choice agrees is the outputs within 2e-5, since a
flipped choice (gate 1) moves its token's output by O(1).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from _torch_lm_ref import (B, LLAMA_FULL, LLAMA_KINDS, LLAMA_MAX_LEN,
                           LLAMA_MOE, LLAMA_PIECE_LEN, LLAMA_PIECE_PROMPTS,
                           LLAMA_PROMPT, LLAMA_SMOKES, LLAMA_TINY,
                           LLAMA_TINY_MAX_LEN, LLAMA_TINY_PROMPT, NEW, STEPS)
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import UNPORTED
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, moe, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
MIN_MARGIN = 1e-5
MIN_MARGIN_DEEP = 1e-6
MIN_REL_GAP = 1e-6     # 8 float32 ulps, as tests/test_torch_moe_router.py
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
NAMES = [SCOUT, SCOUT + "-smoke", MAVERICK, MAVERICK + "-smoke"]
# each model of the dump: (its config, prompt length, cache positions,
# stack_plan)
MODELS = {
    "scout": (LLAMA_SMOKES["scout"], None, LLAMA_PROMPT, LLAMA_MAX_LEN,
              (0, 2, 1, 0)),
    "maverick": (LLAMA_SMOKES["maverick"], None, LLAMA_PROMPT,
                 LLAMA_MAX_LEN, (0, 2, 1, 0)),
    "scout48": (LLAMA_FULL["scout48"], LLAMA_TINY, LLAMA_TINY_PROMPT,
                LLAMA_TINY_MAX_LEN, (0, 4, 12, 0)),
    "maverick48": (LLAMA_FULL["maverick48"], LLAMA_TINY, LLAMA_TINY_PROMPT,
                   LLAMA_TINY_MAX_LEN, (0, 4, 12, 0)),
}
MODEL_IDS = sorted(MODELS)
PIECES = [pytest.param(kind, s, id=f"{kind}-p{s}")
          for kind in LLAMA_KINDS for s in LLAMA_PIECE_PROMPTS]


@pytest.fixture(scope="session")
def ref_dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama4_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "llama4"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def margins(monkeypatch):
    """Records, for every ``moe_block`` the model calls, its tokens'
    smallest gap between the first and second router probability."""
    seen = []
    block = moe.moe_block

    def recording(params, spec, x, **kw):
        logits = moe._router_logits(params, x.reshape(-1, x.shape[-1]))
        p = torch.sort(torch.softmax(logits.double(), dim=-1), dim=-1,
                       descending=True).values
        seen.append((p[:, 0] - p[:, 1]).min().item())
        return block(params, spec, x, **kw)

    monkeypatch.setattr(moe, "moe_block", recording)
    return seen


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def cfg_of(name):
    arch, change, *_ = MODELS[name]
    return dataclasses.replace(get_config(arch), **(change or {}))


def min_margin(name):
    return MIN_MARGIN_DEEP if name.endswith("48") else MIN_MARGIN


def port_params(ref_dump, name):
    flat = {k[len(f"{name}/params/"):]: a for k, a in ref_dump.items()
            if k.startswith(f"{name}/params/")}
    return convert.lm_params_from_reference(flat, cfg_of(name), device="cpu")


def piece(ref_dump, kind):
    """(spec, port params) of the attention piece of ``kind``."""
    cfg = get_config(LLAMA_SMOKES["scout"])
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[LLAMA_KINDS[kind]])
    params = convert._nest(ref_dump, f"attn_{kind}/params", None,
                           torch.device("cpu"))
    return spec, params


def reference_layer_leaf(ref_dump, prefix, cfg, i, leaf, groups="{}"):
    """Layer i's ``leaf`` from the reference's head/scan/tail layout under
    ``prefix``; ``groups`` names the three groups ("layers_{}" in a
    parameter tree, "{}" in a cache)."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    if n_rep == 1 or i < head:
        return ref_dump[f"{prefix}/{groups.format('head')}/{i}/{leaf}"]
    if i < head + n_rep * period:
        r, j = divmod(i - head, period)
        return ref_dump[f"{prefix}/{groups.format('scan')}/{j}/{leaf}"][r]
    i_tail = i - head - n_rep * period
    return ref_dump[f"{prefix}/{groups.format('tail')}/{i_tail}/{leaf}"]


def check_layer_caches(ref_dump, prefix, cfg, cache):
    for i in range(cfg.num_layers):
        for leaf in ("k", "v"):
            close(cache["layers"][i]["kv"][leaf],
                  reference_layer_leaf(ref_dump, prefix, cfg, i,
                                       f"kv/{leaf}"))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    port, want = get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    assert ([dataclasses.asdict(s) for s in port.layer_specs()]
            == [dataclasses.asdict(s) for s in want.layer_specs()])
    assert port.count_params() == want.count_params()
    transformer.check_ported(port)


def test_unported_holds_only_the_frontends_and_the_paper_policy():
    """Since the frontends' slice, only the paper's NetES policy."""
    assert set(UNPORTED) == {"paper-mlp"}


@pytest.mark.parametrize("name,params,moe_layers", [
    (SCOUT, 100_695_572_480, list(range(48))),
    (MAVERICK, 393_637_560_320, list(range(0, 48, 2)))])
def test_full_config_layout(name, params, moe_layers):
    cfg = get_config(name)
    assert cfg.count_params() == params
    specs = cfg.layer_specs()
    assert [i for i, s in enumerate(specs) if s.mixer == "attn_full"] == list(
        range(3, 48, 4))
    assert {(s.mixer, s.window) for s in specs
            if s.mixer != "attn_full"} == {("attn_chunked", 8192)}
    assert [i for i, s in enumerate(specs) if s.ffn == "moe"] == moe_layers
    assert {s.ffn for s in specs} <= {"moe", "swiglu"}
    assert transformer.stack_plan(cfg) == (0, 4, 12, 0)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.qk_norm,
            cfg.rope_theta) == ((16 if name == SCOUT else 128), 1, True, 5e5)
    smoke = get_config(name + "-smoke")
    assert transformer.stack_plan(smoke) == (0, 2, 1, 0)
    assert [(s.mixer, s.ffn) for s in smoke.layer_specs()] == [
        ("attn_chunked", "moe"),
        ("attn_full", "moe" if name == SCOUT else "swiglu")]


@pytest.mark.parametrize("name", [SCOUT, SCOUT + "-smoke"])
def test_cache_rings_hold_the_chunk_on_chunked_layers(name):
    """A chunked layer's ring holds min(max_len, chunk) slots, a global
    layer max_len."""
    cfg = get_config(name)
    for max_len in (cfg.chunk_size // 2, 3 * cfg.chunk_size):
        if name == SCOUT:      # the shapes only: no 48-layer cache here
            lengths = [attention.cache_length(transformer.attn_spec(cfg, ls),
                                              max_len)
                       for ls in cfg.layer_specs()]
        else:
            cache = transformer.init_cache(cfg, 1, max_len, torch.float32,
                                           "cpu")
            lengths = [c["kv"]["k"].shape[1] for c in cache["layers"]]
        assert lengths == [max_len if ls.mixer == "attn_full"
                           else min(max_len, cfg.chunk_size)
                           for ls in cfg.layer_specs()]


# ---------------------------------------------------------------------------
# chunked and global qk-norm attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(LLAMA_KINDS))
def test_attention_block_matches_reference(ref_dump, kind):
    spec, params = piece(ref_dump, kind)
    assert spec.qk_norm and spec.kind == ("full" if kind == "global"
                                          else "chunked")
    close(attention.attention_block(params, spec,
                                    t(ref_dump[f"attn_{kind}/x"]),
                                    torch.arange(LLAMA_PIECE_LEN)),
          ref_dump[f"attn_{kind}/block"])


def test_chunk_mask_moves_the_output(ref_dump):
    """Over three chunks the chunked block differs from the causal one:
    the tolerance above would catch a chunk mask left out."""
    spec, params = piece(ref_dump, "chunked")
    causal = attention.attention_block(
        params, dataclasses.replace(spec, kind="full", window=0),
        t(ref_dump["attn_chunked/x"]), torch.arange(LLAMA_PIECE_LEN))
    want = t(ref_dump["attn_chunked/block"])
    assert (causal - want)[:, :64].abs().max() < 1e-5    # the first chunk
    assert (causal - want)[:, 64:].abs().max() > 1e-3


@pytest.mark.parametrize("kind,s", PIECES)
def test_prefill_attention_matches_reference(ref_dump, kind, s):
    spec, params = piece(ref_dump, kind)
    p = f"attn_{kind}/p{s}"
    kv = attention.init_kv_cache(B, spec, s + 8, torch.float32, "cpu")
    assert kv["k"].shape[1] == (64 if kind == "chunked" else s + 8)
    fa.KERNEL.launches = 0
    y, kv = attention.prefill_attention(params, spec,
                                        t(ref_dump[f"attn_{kind}/x"])[:, :s],
                                        torch.arange(s), kv)
    assert fa.KERNEL.launches == 0          # the CPU runs the plain version
    close(y, ref_dump[f"{p}/prefill"])
    close(kv["k"], ref_dump[f"{p}/prefill_k"])
    close(kv["v"], ref_dump[f"{p}/prefill_v"])


@pytest.mark.parametrize("kind,s", PIECES)
def test_decode_attention_matches_reference(ref_dump, kind, s):
    """Two steps after the prefill: at s = 192 the first position of a new
    chunk (its ring holds only the last chunk's keys, all masked), then
    the second; at s = 176 inside the prefilled chunk."""
    spec, params = piece(ref_dump, kind)
    p = f"attn_{kind}/p{s}"
    kv = {"k": t(ref_dump[f"{p}/prefill_k"]).clone(),
          "v": t(ref_dump[f"{p}/prefill_v"]).clone()}
    for step in range(2):
        pos = torch.full((B,), s + step, dtype=torch.long)
        y, kv = attention.decode_attention(
            params, spec, t(ref_dump[f"{p}/decode{step}_x"]), kv, pos)
        close(y, ref_dump[f"{p}/decode{step}"])
        close(kv["k"], ref_dump[f"{p}/decode{step}_k"])
        close(kv["v"], ref_dump[f"{p}/decode{step}_v"])


def test_decode_at_a_new_chunk_sees_only_its_own_key(ref_dump):
    """At the first position of a chunk, the chunked layer's decode
    output is its own value projected: softmax over one key."""
    spec, params = piece(ref_dump, "chunked")
    p = "attn_chunked/p192"
    kv = {"k": t(ref_dump[f"{p}/prefill_k"]).clone(),
          "v": t(ref_dump[f"{p}/prefill_v"]).clone()}
    x = t(ref_dump[f"{p}/decode0_x"])
    y, _ = attention.decode_attention(params, spec, x, kv,
                                      torch.full((B,), 192, dtype=torch.long))
    _, _, v = attention._qkv(params, spec, x, torch.full((B, 1), 192))
    g = spec.num_heads // spec.num_kv_heads
    own = torch.einsum("bshk,hkd->bsd", v.repeat_interleave(g, dim=2),
                       params["wo"])
    close(y, own.numpy())


# ---------------------------------------------------------------------------
# the MoE layer at top-1, and the router's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LLAMA_MOE))
def test_moe_block_at_top1_matches_reference(ref_dump, name):
    e, dm, ff, group, s = LLAMA_MOE[name]
    spec = moe.MoESpec(num_experts=e, experts_per_token=1, d_model=dm,
                       d_ff=ff, group_size=group)
    params = convert._nest(ref_dump, f"{name}/params", None,
                           torch.device("cpu"))
    x = t(ref_dump[f"{name}/x"])
    logits = moe._router_logits(params, x.reshape(-1, dm))
    p = torch.sort(torch.softmax(logits.double(), dim=-1), dim=-1,
                   descending=True).values
    assert ((p[:, 0] - p[:, 1]) / p[:, 0]).min() > MIN_REL_GAP
    mr.KERNEL.launches = 0
    gates, ids = mr.moe_topk(logits, 1)
    assert mr.KERNEL.launches == 0
    np.testing.assert_array_equal(ids.numpy(), ref_dump[f"{name}/ids"])
    assert torch.equal(gates, torch.ones_like(gates))   # top-1: gate 1
    close(moe.moe_block(params, spec, x), ref_dump[f"{name}/moe_block"])
    cap = moe.group_capacity(spec, min(group, s))
    assert cap == {"e16": 5, "e128": 1, "e128_decode": 1}[name]


def _separated_logits(t_rows: int, e: int, seed: int) -> np.ndarray:
    """(T, E) logits, each row a random permutation of E levels 6 / E
    apart plus noise of a tenth of that: every gap between two
    probabilities is a fixed share of them."""
    rng = np.random.default_rng(seed)
    levels = np.linspace(-3.0, 3.0, e)
    rows = np.stack([rng.permutation(levels) for _ in range(t_rows)])
    noise = rng.uniform(-0.05, 0.05, rows.shape) * (6.0 / e)
    return (rows + noise).astype(np.float32)


@pytest.mark.parametrize("t_rows,e", [(512, 16), (512, 128), (8, 128),
                                      (1, 16)])
def test_router_plain_version_at_top1_matches_reference(t_rows, e):
    """The router's plain version (the wrapper's CPU route) at scout's
    (T, 16, 1) and maverick's (T, 128, 1) against the reference's oracle
    ``repro.kernels.ref.moe_topk_ref`` (``lax.top_k``)."""
    logits = _separated_logits(t_rows, e, seed=t_rows + e)
    p = torch.sort(torch.softmax(torch.from_numpy(logits).double(), dim=-1),
                   dim=-1, descending=True).values
    assert (p[:, 0] - p[:, 1]).min() > 1e-4
    want_gates, want_ids = jref.moe_topk_ref(jnp.asarray(logits), 1)
    mr.KERNEL.launches = 0
    gates, ids = mr.moe_topk(torch.from_numpy(logits), 1)
    assert mr.KERNEL.launches == 0
    assert ids.shape == (t_rows, 1) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               rtol=0, atol=1e-6)
    assert torch.equal(ids, ref.moe_topk_ref(torch.from_numpy(logits), 1)[1])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODEL_IDS)
def test_convert_unstacks_reference_layout(ref_dump, name):
    """Every layer's leaves, q_norm, k_norm and the MoE's included, come
    out of the reference's head/scan/tail layout in layer order."""
    cfg = cfg_of(name)
    params = port_params(ref_dump, name)
    assert len(params["layers"]) == cfg.num_layers
    assert transformer.stack_plan(cfg) == MODELS[name][4]
    for i, (lay, ls) in enumerate(zip(params["layers"], cfg.layer_specs())):
        ffn = "moe" if ls.ffn == "moe" else "ffn"
        assert set(lay) == {"norm1", "norm2", "attn", ffn}
        assert set(lay["attn"]) == {"wq", "wk", "wv", "wo", "q_norm",
                                    "k_norm"}
        leaves = ["attn/wq", "attn/wo", "attn/q_norm/scale",
                  "attn/k_norm/scale", "norm2/scale"]
        leaves += (["moe/router", "moe/w_gate", "moe/w_up", "moe/w_down"]
                   if ffn == "moe" else ["ffn/w_gate", "ffn/w_down"])
        for leaf in leaves:
            node = lay
            for part in leaf.split("/"):
                node = node[part]
            want = reference_layer_leaf(ref_dump, f"{name}/params", cfg, i,
                                        leaf, groups="layers_{}")
            assert np.array_equal(node.numpy(), want), (i, leaf)
    assert convert.lm_params_to_reference(params, cfg).keys() == {
        k[len(f"{name}/params/"):] for k in ref_dump
        if k.startswith(f"{name}/params/")}


@pytest.mark.parametrize("name", MODEL_IDS)
def test_forward_matches_reference(ref_dump, name, margins):
    fa.KERNEL.launches = mr.KERNEL.launches = 0
    tokens = t(ref_dump[f"{name}/forward_tokens"]).long()
    logits = transformer.forward(port_params(ref_dump, name), cfg_of(name),
                                 {"tokens": tokens})
    assert fa.KERNEL.launches == mr.KERNEL.launches == 0
    close(logits, ref_dump[f"{name}/forward_logits"])
    n_moe = sum(ls.ffn == "moe" for ls in cfg_of(name).layer_specs())
    assert len(margins) == n_moe and min(margins) > min_margin(name)


@pytest.mark.parametrize("name", MODEL_IDS)
def test_prefill_and_decode_steps_match_reference(ref_dump, name, margins):
    cfg = cfg_of(name)
    _, _, prompt, max_len, _ = MODELS[name]
    params = port_params(ref_dump, name)
    cache = transformer.init_cache(cfg, B, max_len, torch.float32, "cpu")
    fa.KERNEL.launches = mr.KERNEL.launches = 0
    last, cache = transformer.prefill(
        params, cfg, {"tokens": t(ref_dump[f"{name}/prompts"]).long()}, cache)
    close(last, ref_dump[f"{name}/prefill_logits"])
    check_layer_caches(ref_dump, f"{name}/prefill_cache", cfg, cache)
    steps = t(ref_dump[f"{name}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), prompt + i, dtype=torch.long))
        close(logits, ref_dump[f"{name}/decode_logits"][i])
    check_layer_caches(ref_dump, f"{name}/decode_cache", cfg, cache)
    assert fa.KERNEL.launches == mr.KERNEL.launches == 0
    assert min(margins) > min_margin(name)


@pytest.mark.parametrize("name", MODEL_IDS)
def test_greedy_generate_equals_reference(ref_dump, name, margins):
    engine = ServeEngine(cfg_of(name), port_params(ref_dump, name),
                         max_len=MODELS[name][3], device="cpu")
    out = engine.generate(ref_dump[f"{name}/prompts"], new_tokens=NEW)
    np.testing.assert_array_equal(out, ref_dump[f"{name}/generate_tokens"])
    assert min(margins) > min_margin(name)


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_decode_equals_own_forward_past_a_chunk_boundary(arch):
    """The smoke's pattern at 4 layers (chunked, global, chunked, global):
    a 128-token prefill (two chunks of 64), then decode steps from the
    first position of the third chunk across its end at 192 into the
    fourth, give the logits the full forward gives at the same positions.
    The forward routes each decode position in a group of its own, as
    decode does."""
    cfg = dataclasses.replace(get_config(arch + "-smoke"), num_layers=4)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 200),
                           generator=torch.Generator().manual_seed(4))
    prompt = 128
    full = transformer.forward(params, cfg, {"tokens": tokens[:, :prompt]})
    cache = transformer.init_cache(cfg, 2, 200, torch.float32, "cpu")
    last, cache = transformer.prefill(params, cfg,
                                      {"tokens": tokens[:, :prompt]}, cache)
    close(last, full[:, -1].numpy())
    for i in range(prompt, 200):
        logits, cache = transformer.decode_step(
            params, cfg, tokens[:, i:i + 1], cache,
            torch.full((2,), i, dtype=torch.long))
        if i in (prompt, 191, 192, 193, 199):
            want = _forward_routed_as_served(params, cfg, tokens[:, :i + 1],
                                             prompt)
            close(logits[:, 0], want[:, i].numpy())


def _forward_routed_as_served(params, cfg, tokens, prompt):
    """The full forward with the MoE routing the first ``prompt``
    positions in ``cfg``'s groups and each later one alone."""
    block = moe.moe_block

    def as_served(p, spec, x, **kw):
        head = block(p, spec, x[:, :prompt], **kw)
        tail = block(p, dataclasses.replace(spec, group_size=1),
                     x[:, prompt:], **kw)
        return torch.cat([head, tail], dim=1)

    moe.moe_block = as_served
    try:
        return transformer.forward(params, cfg, {"tokens": tokens})
    finally:
        moe.moe_block = block


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_launcher_serves_llama4_smoke_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch + "-smoke", "--batch", "2",
                       "--prompt-len", "192", "--new-tokens", "4",
                       "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
