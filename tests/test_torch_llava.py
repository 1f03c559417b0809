"""The port's llava-next-mistral-7b slice (early fusion: the vision
frontend's patch embeddings before the token embeddings in one sequence,
the Mistral-7B backbone) against the JAX reference's ``repro.models``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``frontends`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: llava-next-mistral-7b-smoke with the reference's own weights and
16 patches (its ``num_patches``): the forward with the patches (the text
at positions 16 .. 25, after them), ``loss_fn`` with the patches over 10
tokens (one chunk) and 32 tokens (chunks of 16), the prefill and 4 decode
steps of the tokens alone with their caches, and greedy
``ServeEngine.generate`` given the patches, which the reference's serving
drops (its decode embeds tokens only, so its prompt starts at position
0). The port takes those weights through
``convert.lm_params_from_reference`` and runs on the CPU, where the flash
kernel's wrapper runs its plain version.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in other
orders (≈ 1e-6 at these widths); patches after the tokens, or the text's
RoPE positions starting at 0, move the outputs by ≥ 1e-3. Greedy tokens
are held EQUAL.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from _torch_lm_ref import (B, FRONT_ARCHS, LLAVA_LOSS_LENS,
                           LLAVA_XENT_CHUNK, MAX_LEN, NEW, PROMPT, STEPS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve as launch_serve
from repro_torch.models import frontends, layers, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
LLAVA = "llava-next-mistral-7b"
NAMES = [LLAVA, LLAVA + "-smoke"]
SMOKE = get_config(FRONT_ARCHS["llava"])


@pytest.fixture(scope="session")
def front(tmp_path_factory):
    path = tmp_path_factory.mktemp("frontends_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "frontends"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.fixture
def params(front):
    flat = {k[len("llava/params/"):]: a for k, a in front.items()
            if k.startswith("llava/params/")}
    return convert.lm_params_from_reference(flat, SMOKE, device="cpu")


def patches_of(front):
    return t(front["llava/patch_embeds"])


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


def test_full_config_layout():
    cfg = get_config(LLAVA)
    assert cfg.count_params() == 7_110_656_000
    assert (cfg.num_patches, cfg.frontend, cfg.learned_pos, cfg.use_rope,
            cfg.rope_theta) == (2880, "vision", False, True, 1e6)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 128)
    assert {(s.mixer, s.ffn) for s in cfg.layer_specs()} == {
        ("attn_full", "swiglu")}
    assert transformer.stack_plan(cfg) == (0, 1, 32, 0)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_forward_with_patches_matches_reference(front, params):
    logits = transformer.forward(
        params, SMOKE, {"tokens": t(front["llava/forward_tokens"]).long(),
                        "patch_embeds": patches_of(front)})
    assert logits.shape[1] == SMOKE.num_patches + front[
        "llava/forward_tokens"].shape[1]
    close(logits, front["llava/forward_logits"])


@pytest.mark.parametrize("s", LLAVA_LOSS_LENS)
def test_loss_fn_with_patches_matches_reference(front, params, s):
    """The kernel path (float32; the plain versions on the CPU) and the
    float64 forward's layers, the patches' positions dropped before the
    cross-entropy."""
    tokens = t(front[f"llava/loss{s}_tokens"]).long()
    batch = {"tokens": tokens, "labels": tokens,
             "patch_embeds": patches_of(front)}
    got = transformer.loss_fn(params, SMOKE, batch,
                              xent_chunk=LLAVA_XENT_CHUNK)
    np.testing.assert_allclose(got.numpy(), front[f"llava/loss{s}"], **TOL)
    got64 = transformer.loss_fn(tree_map(lambda x: x.double(), params),
                                SMOKE, batch, xent_chunk=LLAVA_XENT_CHUNK)
    np.testing.assert_allclose(got64.item(), front[f"llava/loss{s}"],
                               rtol=2e-5)


def test_prefill_and_decode_steps_match_reference(front, params):
    cache = transformer.init_cache(SMOKE, B, MAX_LEN, torch.float32, "cpu")
    last, cache = transformer.prefill(
        params, SMOKE, {"tokens": t(front["llava/prompts"]).long()}, cache)
    close(last, front["llava/prefill_logits"])
    steps = t(front["llava/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, SMOKE, steps[:, i:i + 1], cache,
            torch.full((B,), PROMPT + i, dtype=torch.long))
        close(logits, front["llava/decode_logits"][i])
    for i in range(SMOKE.num_layers):
        for leaf in ("k", "v"):
            close(cache["layers"][i]["kv"][leaf],
                  front[f"llava/decode_cache/head/{i}/kv/{leaf}"])


def test_greedy_generate_with_patches_equals_reference(front, params):
    engine = ServeEngine(SMOKE, params, max_len=MAX_LEN, device="cpu")
    out = engine.generate(front["llava/prompts"], new_tokens=NEW,
                          extra_batch={"patch_embeds":
                                       front["llava/patch_embeds"]})
    np.testing.assert_array_equal(out, front["llava/generate_tokens"])


# ---------------------------------------------------------------------------
# early fusion and the RoPE positions
# ---------------------------------------------------------------------------

def test_patches_come_first_and_the_text_starts_after_them():
    """In the forward the sequence is [patches ; tokens] at positions
    0 .. P + S − 1: the text starts at position P."""
    params = transformer.init_params(SMOKE, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    patches = frontends.vision_patches(SMOKE, 2, gen)
    tokens = torch.randint(0, SMOKE.vocab_size, (2, 5), generator=gen)
    x, positions, enc_out = transformer.embed_inputs(
        params, SMOKE, {"tokens": tokens, "patch_embeds": patches})
    p = SMOKE.num_patches
    assert enc_out is None
    assert torch.equal(positions, torch.arange(p + 5))
    assert torch.equal(x[:, :p], patches)
    assert torch.equal(x[:, p:], params["embed"][tokens])
    with_patches = transformer.forward(
        params, SMOKE, {"tokens": tokens, "patch_embeds": patches})[:, p:]
    alone = transformer.forward(params, SMOKE, {"tokens": tokens})
    assert (with_patches - alone).abs().max() > 1e-3


def test_serving_drops_the_patches_and_starts_at_position_zero():
    """``generate`` given the patches equals ``generate`` without them,
    and its first token is the argmax of the forward over the prompt
    alone (positions from 0)."""
    params = transformer.init_params(SMOKE, seed=1, device="cpu")
    engine = ServeEngine(SMOKE, params, max_len=16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    patches = frontends.vision_patches(SMOKE, 2, gen)
    prompts = torch.randint(0, SMOKE.vocab_size, (2, 6), generator=gen)
    out = engine.generate(prompts, new_tokens=4,
                          extra_batch={"patch_embeds": patches})
    np.testing.assert_array_equal(out, engine.generate(prompts,
                                                       new_tokens=4))
    first = transformer.forward(params, SMOKE,
                                {"tokens": prompts})[:, -1].argmax(-1)
    np.testing.assert_array_equal(out[:, 0], first.numpy())


def test_loss_fn_scores_the_text_positions_only():
    """``loss_fn`` with patches is the mean next-token cross-entropy of the
    forward's text positions."""
    params = transformer.init_params(SMOKE, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    patches = frontends.vision_patches(SMOKE, 2, gen)
    tokens = torch.randint(0, SMOKE.vocab_size, (2, 12), generator=gen)
    batch = {"tokens": tokens, "labels": tokens, "patch_embeds": patches}
    logits = transformer.forward(params, SMOKE, batch)[:, SMOKE.num_patches:]
    xent = layers.softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    got = transformer.loss_fn(params, SMOKE, batch)
    np.testing.assert_allclose(got.item(), xent.mean().item(), **TOL)
    assert math.isfinite(got.item())


def test_launcher_serves_llava_smoke_on_cpu(capsys):
    launch_serve.main(["--arch", LLAVA + "-smoke", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "4",
                       "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
