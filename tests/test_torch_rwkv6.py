"""The port's rwkv6 model (``repro_torch.models.rwkv6`` and the rwkv
branches of ``transformer``) against the JAX reference's
``repro.models.rwkv6`` and ``transformer``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``rwkv`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: a time mix of d 64 in 2 heads of 32 whose parameters are moved
away from the init's constants (random mixes, LoRAs of scale ≈ 1, decays
w in (0.69, 0.98), a random bonus), so that every term moves the output;
``_time_shift``, ``_mix_inputs``, ``wkv6_chunked`` at S = 48 (a multiple
of the chunk of 16) and S = 40 (the sequential fallback), from a zero
and a random state; ``rwkv6_block``; ``rwkv6_prefill`` from a zero and a
seeded cache, then 4 teacher-forced ``rwkv6_decode`` steps; the channel
mix with and without ``x_prev``; and the whole rwkv6-7b-smoke model (2
layers unrolled, 4 scanned) with the reference's own weights: forward,
prefill with its cache, 4 decode steps with their cache, greedy
``generate``. The port takes those weights through
``convert.lm_params_from_reference`` and runs on the CPU, where the WKV
kernel's wrapper runs its plain version.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in
other orders (≈ 1e-6 at these widths); a missing or misplaced term
(the bonus, a decay, a token shift, the LoRA) moves the outputs by
≥ 1e-3. ``wkv6_chunked`` divides by in-chunk decay products down to
0.69¹⁶ ≈ 3e-3, which scales its rounding by up to 300, so it alone is
held to 2e-4. A layer's WKV state in the model's cache is a sum over
the prompt of outer products k vᵀ whose entries cancel: it is held within
2e-5 · max(1, max|state|) (it carries ≈ 2e-6 of its scale through 4
layers, while one step's k vᵀ missing moves it by ≥ 1e-2 of it). Greedy
tokens are held EQUAL.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm_ref import (B, MAX_LEN, NEW, PROMPT, RWKV_CHUNK, RWKV_D,
                           RWKV_HEADS, STEPS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_wkv as rw
from repro_torch.launch import serve as launch_serve
from repro_torch.models import rwkv6, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_CHUNKED = dict(rtol=2e-4, atol=2e-4)
SMOKE = "rwkv6-7b-smoke"
SPEC = rwkv6.RWKV6Spec(d_model=RWKV_D, num_heads=RWKV_HEADS)
MODELS = [pytest.param(2, id="2-unrolled"), pytest.param(4, id="4-scanned")]


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("rwkv_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "rwkv"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def close_to_scale(got, want):
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL["atol"] * max(1.0, np.abs(want).max()), err


def tree(ref, prefix):
    """The dump's leaves under ``prefix`` as nested dicts of tensors."""
    return convert._nest(ref, prefix, None, torch.device("cpu"))


def cfg_of(n_layers):
    return dataclasses.replace(get_config(SMOKE), num_layers=n_layers)


def port_params(ref, n_layers):
    flat = {k[len(f"rwkv{n_layers}/params/"):]: a for k, a in ref.items()
            if k.startswith(f"rwkv{n_layers}/params/")}
    return convert.lm_params_from_reference(flat, cfg_of(n_layers),
                                            device="cpu")


def reference_layer_cache(ref, prefix, cfg, i):
    """Layer i's (s, x_prev, channel_x_prev) from the reference's
    head/scan/tail cache."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    names = ("rwkv/s", "rwkv/x_prev", "channel_x_prev")
    if n_rep == 1 or i < head:
        return [ref[f"{prefix}/head/{i}/{nm}"] for nm in names]
    r, j = divmod(i - head, period)
    return [ref[f"{prefix}/scan/{j}/{nm}"][r] for nm in names]


def check_layer_caches(ref, prefix, cfg, cache):
    for i in range(cfg.num_layers):
        s, x_prev, ch = reference_layer_cache(ref, prefix, cfg, i)
        c = cache["layers"][i]
        close_to_scale(c["rwkv"]["s"], s)
        close(c["rwkv"]["x_prev"], x_prev)
        close(c["channel_x_prev"], ch)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_time_shift_matches_reference(ref):
    x = t(ref["block/x"])
    close(rwkv6._time_shift(x), ref["time_shift/zero"])
    close(rwkv6._time_shift(x, t(ref["block/last"])), ref["time_shift/last"])


def test_mix_inputs_match_reference(ref):
    params = tree(ref, "block/params")
    x = t(ref["block/x"])
    mixed = rwkv6._mix_inputs(params, x, rwkv6._time_shift(x))
    for name, m in zip("rkvwg", mixed):
        close(m, ref[f"mix_inputs/{name}"])


@pytest.mark.parametrize("s", [48, 40], ids=["chunked", "fallback"])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "s0"])
def test_wkv6_chunked_matches_reference(ref, s, seeded):
    a = {n: t(ref[f"wkv{s}/{n}"]) for n in ("r", "k", "v", "w", "u", "s0")}
    out, s_fin = rwkv6.wkv6_chunked(a["r"], a["k"], a["v"], a["w"], a["u"],
                                    s0=a["s0"] if seeded else None,
                                    chunk=RWKV_CHUNK)
    tag = "_s0" if seeded else ""
    close(out, ref[f"wkv{s}/out{tag}"], TOL_CHUNKED)
    close(s_fin, ref[f"wkv{s}/s_fin{tag}"], TOL_CHUNKED)


def test_rwkv6_block_matches_reference(ref):
    out = rwkv6.rwkv6_block(tree(ref, "block/params"), SPEC,
                            t(ref["block/x"]), chunk=RWKV_CHUNK)
    close(out, ref["block/out"], TOL_CHUNKED)


@pytest.mark.parametrize("name", ["zero", "seeded"])
def test_rwkv6_prefill_matches_reference(ref, name):
    params = tree(ref, "block/params")
    cache = (rwkv6.init_rwkv_cache(B, SPEC, torch.float32, "cpu")
             if name == "zero" else tree(ref, "prefill/seed"))
    rw.KERNEL.launches = 0
    y, c = rwkv6.rwkv6_prefill(params, SPEC, t(ref["block/x"])[:, :40],
                               cache)
    assert rw.KERNEL.launches == 0          # the CPU runs the plain version
    close(y, ref[f"prefill/{name}/out"])
    close(c["s"], ref[f"prefill/{name}/cache/s"])
    close(c["x_prev"], ref[f"prefill/{name}/cache/x_prev"])


def test_rwkv6_decode_steps_match_reference(ref):
    params = tree(ref, "block/params")
    x = t(ref["block/x"])
    _, c = rwkv6.rwkv6_prefill(params, SPEC, x[:, :40],
                               tree(ref, "prefill/seed"))
    ys = []
    for step in range(40, 44):
        y, c = rwkv6.rwkv6_decode(params, SPEC, x[:, step:step + 1], c)
        ys.append(y)
    close(torch.cat(ys, dim=1), ref["decode/out"])
    close(c["s"], ref["decode/cache/s"])
    close(c["x_prev"], ref["decode/cache/x_prev"])


@pytest.mark.parametrize("with_last", [False, True], ids=["zeros", "x_prev"])
def test_rwkv6_channel_matches_reference(ref, with_last):
    params = tree(ref, "channel/params")
    last = t(ref["block/last"]) if with_last else None
    out = rwkv6.rwkv6_channel(params, t(ref["block/x"]), last)
    close(out, ref["channel/out_last" if with_last else "channel/out"])


def test_decode_equals_own_block():
    """The counterpart of the reference's own test (tests/test_models.py,
    ``test_rwkv_block_decode_matches_prefill``): 24 decode steps through
    the kernel's route equal the full block through the chunked form."""
    spec = rwkv6.RWKV6Spec(d_model=64, num_heads=2)
    gen = torch.Generator().manual_seed(0)
    p = rwkv6.rwkv6_init(gen, spec, torch.float32)
    x = 0.2 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((1, 24, 64)),
        dtype=torch.float32)
    full = rwkv6.rwkv6_block(p, spec, x, chunk=8)
    c = rwkv6.init_rwkv_cache(1, spec, torch.float32, "cpu")
    outs = []
    for step in range(24):
        o, c = rwkv6.rwkv6_decode(p, spec, x[:, step:step + 1], c)
        outs.append(o)
    # the reference's own tolerance for this comparison
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-4, atol=5e-4)
    y, cp = rwkv6.rwkv6_prefill(p, spec, x, rwkv6.init_rwkv_cache(
        1, spec, torch.float32, "cpu"))
    close(y, full.numpy(), TOL_CHUNKED)
    close(cp["s"], c["s"].numpy())


def test_lora_accumulates_in_float64_for_float64():
    p = {"a": torch.ones(4, 2, dtype=torch.float64),
         "b": torch.ones(2, 4, dtype=torch.float64),
         "bias": torch.zeros(4)}
    assert rwkv6._lora(p, torch.ones(1, 1, 4, dtype=torch.float64)).dtype \
        == torch.float64
    p32 = {k: v.float() for k, v in p.items()}
    assert rwkv6._lora(p32, torch.ones(1, 1, 4)).dtype == torch.float32


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", MODELS)
def test_convert_unstacks_reference_layout(ref, n_layers):
    cfg = cfg_of(n_layers)
    params = port_params(ref, n_layers)
    plan = transformer.stack_plan(cfg)
    assert plan == ((0, 2, 1, 0) if n_layers == 2 else (0, 1, 4, 0))
    assert len(params["layers"]) == n_layers
    for i, lay in enumerate(params["layers"]):
        assert set(lay) == {"norm1", "norm2", "rwkv", "ffn"}
        for name in ("rwkv/wr", "rwkv/mix", "rwkv/decay_lora/a",
                     "rwkv/bonus_u", "ffn/wk", "ffn/mix_r"):
            key = (f"rwkv{n_layers}/params/layers_head/{i}/{name}"
                   if n_layers == 2 else
                   f"rwkv{n_layers}/params/layers_scan/0/{name}")
            want = ref[key] if n_layers == 2 else ref[key][i]
            node = lay
            for part in name.split("/"):
                node = node[part]
            assert np.array_equal(node.numpy(), want)


@pytest.mark.parametrize("n_layers", MODELS)
def test_forward_matches_reference(ref, n_layers):
    rw.KERNEL.launches = 0
    logits = transformer.forward(
        port_params(ref, n_layers), cfg_of(n_layers),
        {"tokens": t(ref[f"rwkv{n_layers}/forward_tokens"]).long()})
    assert rw.KERNEL.launches == 0
    close(logits, ref[f"rwkv{n_layers}/forward_logits"])


@pytest.mark.parametrize("n_layers", MODELS)
def test_prefill_and_decode_steps_match_reference(ref, n_layers):
    cfg, p = cfg_of(n_layers), f"rwkv{n_layers}"
    params = port_params(ref, n_layers)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    fa.KERNEL.launches = rw.KERNEL.launches = 0
    last, cache = transformer.prefill(
        params, cfg, {"tokens": t(ref[f"{p}/prompts"]).long()}, cache)
    close(last, ref[f"{p}/prefill_logits"])
    check_layer_caches(ref, f"{p}/prefill_cache", cfg, cache)
    steps = t(ref[f"{p}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), PROMPT + i, dtype=torch.long))
        close(logits, ref[f"{p}/decode_logits"][i])
    check_layer_caches(ref, f"{p}/decode_cache", cfg, cache)
    # the CPU runs the plain versions
    assert fa.KERNEL.launches == rw.KERNEL.launches == 0


@pytest.mark.parametrize("n_layers", MODELS)
def test_greedy_generate_equals_reference(ref, n_layers):
    p = f"rwkv{n_layers}"
    engine = ServeEngine(cfg_of(n_layers), port_params(ref, n_layers),
                         max_len=MAX_LEN, device="cpu")
    out = engine.generate(ref[f"{p}/prompts"], new_tokens=NEW)
    np.testing.assert_array_equal(out, ref[f"{p}/generate_tokens"])


def test_decode_equals_own_prefill():
    """The model's decode steps give the logits its full forward and its
    prefill give at the same positions."""
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(4))
    full = transformer.forward(params, cfg, {"tokens": tokens})
    cache = transformer.init_cache(cfg, 2, 12, torch.float32, "cpu")
    last, cache = transformer.prefill(params, cfg, {"tokens": tokens[:, :8]},
                                      cache)
    close(last, full[:, 7].numpy())
    for i in range(8, 12):
        logits, cache = transformer.decode_step(
            params, cfg, tokens[:, i:i + 1], cache,
            torch.full((2,), i, dtype=torch.long))
        close(logits[:, 0], full[:, i].numpy())


def test_launcher_serves_rwkv_on_cpu(capsys):
    launch_serve.main(["--arch", SMOKE, "--batch", "2", "--prompt-len", "16",
                       "--new-tokens", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_rwkv_cache_has_the_references_leaves():
    cfg = get_config(SMOKE)
    cache = transformer.init_cache(cfg, 3, 8, torch.float32, "cpu")
    n = cfg.head_dim
    for c in cache["layers"]:
        assert set(c) == {"rwkv", "channel_x_prev"}
        assert c["rwkv"]["s"].shape == (3, cfg.num_heads, n, n)
        assert c["rwkv"]["s"].dtype == torch.float32
        assert c["rwkv"]["x_prev"].shape == (3, 1, cfg.d_model)
        assert c["channel_x_prev"].shape == (3, 1, cfg.d_model)


def test_prefill_cache_holds_copies_not_views_of_the_activations():
    """The cache's token shifts are the last rows as tensors of their own:
    a view would keep each layer's whole (B, S, D) input alive."""
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=5, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(6))
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, "cpu")
    _, cache = transformer.prefill(params, cfg, {"tokens": tokens}, cache)
    row_bytes = 2 * cfg.d_model * 4
    for c in cache["layers"]:
        for t_ in (c["rwkv"]["x_prev"], c["channel_x_prev"]):
            assert t_.shape == (2, 1, cfg.d_model)
            assert t_.untyped_storage().nbytes() == row_bytes
