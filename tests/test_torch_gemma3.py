"""The port's gemma3-4b slice (qk-norm attention; 5:1 sliding/global
layers; head_dim 256) against the JAX reference's ``repro.models``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``gemma`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: qk-norm attention pieces of the smoke's widths at head_dim 64 and
256, on the smoke's sliding layer (window 64) and its global layer, with
q_norm and k_norm scales moved away from the init's ones so that they
move the output (``attention_block``; ``prefill_attention`` of 100 tokens
into a 104-position cache, whose 64-slot sliding ring wraps, with the
cache's slots; one ``decode_attention`` step at positions 100 and 103
with the cache after it); and whole models with the reference's own
weights: gemma3-4b-smoke at 2 layers (unrolled: sliding, then global), at
8 (scanned as plan (0, 2, 4, 0)) and at 2 with head_dim 256, with a
128-token forward, a 128-token prefill with its cache (twice the window,
so the ring wraps), 4 decode steps with their cache and greedy
``generate``; and a 34-layer model of gemma3-4b's layer pattern at tiny
widths (plan (0, 6, 5, 4): the period of 5 sliding layers and 1 global
stacked 5 times, then 4 sliding layers unrolled) with 16-token prompts,
twice its window of 8. The port takes those weights through
``convert.lm_params_from_reference`` and runs on the CPU, where the flash
kernel's wrapper runs its plain version.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in other
orders, ≈ 1e-6 at these widths; a missing qk-norm, a norm after RoPE
instead of before, a wrong window or a layer out of order moves the
outputs by ≥ 1e-3. Greedy tokens are held EQUAL.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from _torch_lm_ref import (B, GEMMA_HEAD_DIMS, GEMMA_KINDS, GEMMA_MAX_LEN,
                           GEMMA_PIECE_LEN, GEMMA_PROMPT, GEMMA_TINY,
                           GEMMA_TINY_MAX_LEN, GEMMA_TINY_PROMPT, NEW, STEPS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
ARCH, SMOKE = "gemma3-4b", "gemma3-4b-smoke"
# each model of the dump: (the changes to its base config, prompt length,
# cache positions, stack_plan)
MODELS = {
    "gemma2": (dict(num_layers=2), GEMMA_PROMPT, GEMMA_MAX_LEN, (0, 2, 1, 0)),
    "gemma8": (dict(num_layers=8), GEMMA_PROMPT, GEMMA_MAX_LEN, (0, 2, 4, 0)),
    "gemma2_hd256": (dict(num_layers=2, head_dim=256), GEMMA_PROMPT,
                     GEMMA_MAX_LEN, (0, 2, 1, 0)),
    "gemma34": (GEMMA_TINY, GEMMA_TINY_PROMPT, GEMMA_TINY_MAX_LEN,
                (0, 6, 5, 4)),
}
MODEL_IDS = sorted(MODELS)
PIECES = [pytest.param(hd, kind, id=f"hd{hd}-{kind}")
          for hd in GEMMA_HEAD_DIMS for kind in GEMMA_KINDS]


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("gemma_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "gemma"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def cfg_of(name):
    """The config of the dump ``name``: the full config's layer pattern at
    tiny widths for ``gemma34``, else the smoke's."""
    base = get_config(ARCH if name == "gemma34" else SMOKE)
    return dataclasses.replace(base, **MODELS[name][0])


def port_params(ref, name):
    flat = {k[len(f"{name}/params/"):]: a for k, a in ref.items()
            if k.startswith(f"{name}/params/")}
    return convert.lm_params_from_reference(flat, cfg_of(name), device="cpu")


def piece(ref, hd, kind):
    """(spec, port params) of the attention piece at ``hd`` and ``kind``."""
    cfg = dataclasses.replace(get_config(SMOKE), head_dim=hd)
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[GEMMA_KINDS[kind]])
    params = convert._nest(ref, f"attn{hd}_{kind}/params", None,
                           torch.device("cpu"))
    return spec, params


def reference_layer_leaf(ref, prefix, cfg, i, leaf, groups="{}"):
    """Layer i's ``leaf`` from the reference's head/scan/tail layout under
    ``prefix``; ``groups`` names the three groups ("layers_{}" in a
    parameter tree, "{}" in a cache)."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    if n_rep == 1 or i < head:
        return ref[f"{prefix}/{groups.format('head')}/{i}/{leaf}"]
    if i < head + n_rep * period:
        r, j = divmod(i - head, period)
        return ref[f"{prefix}/{groups.format('scan')}/{j}/{leaf}"][r]
    i_tail = i - head - n_rep * period
    return ref[f"{prefix}/{groups.format('tail')}/{i_tail}/{leaf}"]


def check_layer_caches(ref, prefix, cfg, cache):
    for i in range(cfg.num_layers):
        for leaf in ("k", "v"):
            close(cache["layers"][i]["kv"][leaf],
                  reference_layer_leaf(ref, prefix, cfg, i, f"kv/{leaf}"))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, SMOKE])
def test_config_equals_reference(name):
    port, want = get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    assert ([dataclasses.asdict(s) for s in port.layer_specs()]
            == [dataclasses.asdict(s) for s in want.layer_specs()])
    assert port.count_params() == want.count_params()


def test_full_config_layout():
    cfg = get_config(ARCH)
    assert cfg.count_params() == 3_879_905_280
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.qk_norm) == (
        34, 2560, 256, True)
    mixers = [s.mixer for s in cfg.layer_specs()]
    assert [i for i, m in enumerate(mixers) if m == "attn_full"] == [
        5, 11, 17, 23, 29]
    assert {s.window for s in cfg.layer_specs()
            if s.mixer == "attn_sliding"} == {1024}
    assert transformer.stack_plan(cfg) == (0, 6, 5, 4)
    # the tail's first layer is layer 30, a sliding layer
    assert mixers[30:] == ["attn_sliding"] * 4
    smoke = get_config(SMOKE)
    assert transformer.stack_plan(smoke) == (0, 2, 1, 0)
    assert transformer.stack_plan(dataclasses.replace(
        smoke, num_layers=8)) == (0, 2, 4, 0)


def test_qk_norm_adds_ones_and_moves_no_draw():
    """``attn_init`` adds q_norm and k_norm of ones, drawing nothing: the
    projections equal those drawn without qk-norm from the same seed."""
    spec = transformer.attn_spec(get_config(SMOKE),
                                 get_config(SMOKE).layer_specs()[0])
    with_norm = attention.attn_init(torch.Generator().manual_seed(3), 256,
                                    spec, torch.float32)
    without = attention.attn_init(torch.Generator().manual_seed(3), 256,
                                  dataclasses.replace(spec, qk_norm=False),
                                  torch.float32)
    assert set(with_norm) - set(without) == {"q_norm", "k_norm"}
    for name in without:
        assert torch.equal(with_norm[name], without[name])
    for name in ("q_norm", "k_norm"):
        assert torch.equal(with_norm[name]["scale"], torch.ones(64))


@pytest.mark.parametrize("name", [ARCH, SMOKE])
def test_cache_rings_hold_the_window_on_sliding_layers(name):
    """A sliding layer's ring holds min(max_len, window) slots, a global
    layer max_len."""
    cfg = get_config(name)
    for max_len in (cfg.sliding_window // 2, 3 * cfg.sliding_window):
        if name == ARCH:       # the shapes only: no 34-layer cache here
            lengths = [attention.cache_length(transformer.attn_spec(cfg, ls),
                                              max_len)
                       for ls in cfg.layer_specs()]
        else:
            cache = transformer.init_cache(cfg, 1, max_len, torch.float32,
                                           "cpu")
            lengths = [c["kv"]["k"].shape[1] for c in cache["layers"]]
        assert lengths == [max_len if ls.mixer == "attn_full"
                           else min(max_len, cfg.sliding_window)
                           for ls in cfg.layer_specs()]


# ---------------------------------------------------------------------------
# qk-norm attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,kind", PIECES)
def test_attention_block_matches_reference(ref, hd, kind):
    spec, params = piece(ref, hd, kind)
    assert spec.qk_norm and spec.head_dim == hd
    p = f"attn{hd}_{kind}"
    close(attention.attention_block(params, spec, t(ref[f"{p}/x"]),
                                    torch.arange(GEMMA_PIECE_LEN)),
          ref[f"{p}/block"])


@pytest.mark.parametrize("hd,kind", PIECES)
def test_prefill_attention_matches_reference(ref, hd, kind):
    spec, params = piece(ref, hd, kind)
    p = f"attn{hd}_{kind}"
    kv = attention.init_kv_cache(B, spec, GEMMA_PIECE_LEN + 4, torch.float32,
                                 "cpu")
    assert kv["k"].shape[1] == (64 if kind == "sliding"
                                else GEMMA_PIECE_LEN + 4)
    fa.KERNEL.launches = 0
    y, kv = attention.prefill_attention(params, spec, t(ref[f"{p}/x"]),
                                        torch.arange(GEMMA_PIECE_LEN), kv)
    assert fa.KERNEL.launches == 0          # the CPU runs the plain version
    close(y, ref[f"{p}/prefill"])
    close(kv["k"], ref[f"{p}/prefill_k"])
    close(kv["v"], ref[f"{p}/prefill_v"])


@pytest.mark.parametrize("hd,kind", PIECES)
def test_decode_attention_matches_reference(ref, hd, kind):
    spec, params = piece(ref, hd, kind)
    p = f"attn{hd}_{kind}"
    kv = {"k": t(ref[f"{p}/prefill_k"]).clone(),
          "v": t(ref[f"{p}/prefill_v"]).clone()}
    y, kv = attention.decode_attention(params, spec, t(ref[f"{p}/decode_x"]),
                                       kv, t(ref[f"{p}/decode_pos"]).long())
    close(y, ref[f"{p}/decode"])
    close(kv["k"], ref[f"{p}/decode_k"])
    close(kv["v"], ref[f"{p}/decode_v"])


@pytest.mark.parametrize("hd", GEMMA_HEAD_DIMS)
def test_qk_norm_moves_the_output(ref, hd):
    """Without the norms the piece's output is another one: the tolerance
    above would catch a missing qk-norm."""
    spec, params = piece(ref, hd, "global")
    p = f"attn{hd}_global"
    plain = attention.attention_block(
        params, dataclasses.replace(spec, qk_norm=False), t(ref[f"{p}/x"]),
        torch.arange(GEMMA_PIECE_LEN))
    assert (plain - t(ref[f"{p}/block"])).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODEL_IDS)
def test_convert_unstacks_reference_layout(ref, name):
    """Every layer's leaves, q_norm and k_norm included, come out of the
    reference's head/scan/tail layout in layer order."""
    cfg = cfg_of(name)
    params = port_params(ref, name)
    assert len(params["layers"]) == cfg.num_layers
    assert transformer.stack_plan(cfg) == MODELS[name][3]
    names = ("attn/wq", "attn/wk", "attn/wo", "attn/q_norm/scale",
             "attn/k_norm/scale", "ffn/w_up", "norm1/scale")
    for i, lay in enumerate(params["layers"]):
        assert set(lay) == {"norm1", "norm2", "attn", "ffn"}
        assert set(lay["attn"]) == {"wq", "wk", "wv", "wo", "q_norm",
                                    "k_norm"}
        for leaf in names:
            node = lay
            for part in leaf.split("/"):
                node = node[part]
            want = reference_layer_leaf(ref, f"{name}/params", cfg, i, leaf,
                                        groups="layers_{}")
            assert np.array_equal(node.numpy(), want), (i, leaf)
    assert params["layers"][0]["attn"]["wq"].shape[-1] == cfg.head_dim


@pytest.mark.parametrize("name", MODEL_IDS)
def test_forward_matches_reference(ref, name):
    fa.KERNEL.launches = 0
    logits = transformer.forward(port_params(ref, name), cfg_of(name),
                                 {"tokens": t(ref[f"{name}/forward_tokens"])
                                  .long()})
    assert fa.KERNEL.launches == 0
    close(logits, ref[f"{name}/forward_logits"])


@pytest.mark.parametrize("name", MODEL_IDS)
def test_prefill_and_decode_steps_match_reference(ref, name):
    cfg = cfg_of(name)
    _, prompt, max_len, _ = MODELS[name]
    params = port_params(ref, name)
    cache = transformer.init_cache(cfg, B, max_len, torch.float32, "cpu")
    fa.KERNEL.launches = 0
    last, cache = transformer.prefill(
        params, cfg, {"tokens": t(ref[f"{name}/prompts"]).long()}, cache)
    close(last, ref[f"{name}/prefill_logits"])
    check_layer_caches(ref, f"{name}/prefill_cache", cfg, cache)
    steps = t(ref[f"{name}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), prompt + i, dtype=torch.long))
        close(logits, ref[f"{name}/decode_logits"][i])
    check_layer_caches(ref, f"{name}/decode_cache", cfg, cache)
    assert fa.KERNEL.launches == 0          # the CPU runs the plain version


@pytest.mark.parametrize("name", MODEL_IDS)
def test_greedy_generate_equals_reference(ref, name):
    engine = ServeEngine(cfg_of(name), port_params(ref, name),
                         max_len=MODELS[name][2], device="cpu")
    out = engine.generate(ref[f"{name}/prompts"], new_tokens=NEW)
    np.testing.assert_array_equal(out, ref[f"{name}/generate_tokens"])


def test_decode_equals_own_forward_past_the_window():
    """The smoke model's prefill and decode steps give the logits its full
    forward gives at the same positions, past the window of 64."""
    cfg = dataclasses.replace(get_config(SMOKE), num_layers=4)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 136),
                           generator=torch.Generator().manual_seed(4))
    full = transformer.forward(params, cfg, {"tokens": tokens})
    cache = transformer.init_cache(cfg, 2, 136, torch.float32, "cpu")
    last, cache = transformer.prefill(params, cfg,
                                      {"tokens": tokens[:, :128]}, cache)
    close(last, full[:, 127].numpy())
    for i in range(128, 136):
        logits, cache = transformer.decode_step(
            params, cfg, tokens[:, i:i + 1], cache,
            torch.full((2,), i, dtype=torch.long))
        close(logits[:, 0], full[:, i].numpy())


def test_float64_forward_is_a_float64_reference():
    """The float64 forward (the card's reference) computes in float64,
    qk-norm included, and agrees with the float32 one."""
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=5, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 80),
                           generator=torch.Generator().manual_seed(6))
    def double(tree):
        if isinstance(tree, dict):
            return {k: double(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [double(v) for v in tree]
        return tree.double()

    p64 = double(params)
    out64 = transformer.forward(p64, cfg, {"tokens": tokens})
    assert out64.dtype == torch.float64
    close(transformer.forward(params, cfg, {"tokens": tokens}),
          out64.numpy())


def test_launcher_serves_gemma_on_cpu(capsys):
    launch_serve.main(["--arch", SMOKE, "--batch", "2", "--prompt-len", "128",
                       "--new-tokens", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
