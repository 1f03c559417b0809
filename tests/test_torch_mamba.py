"""The port's mamba mixer (``repro_torch.models.mamba``) and the hybrid
branches of ``transformer`` (jamba-v0.1-52b: mamba, sliding attention and
MoE layers) against the JAX reference's ``repro.models.mamba`` and
``transformer``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``mamba`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: a mixer of d_model 32 (d_inner 64, d_state 8) whose Δ bias, A,
D and conv bias are moved away from the init's constants, so that every
term moves the output; ``_ssm_inputs``, ``_causal_conv``,
``_selective_terms`` and the associative ``mamba_scan_ref`` on a 48-token
input; ``mamba_block`` whole and on its chunked path (chunks of 16);
``mamba_prefill`` over 40 tokens and over 2 (shorter than the conv ring),
then 4 teacher-forced ``mamba_decode`` steps; and the whole
jamba-v0.1-52b-smoke model (2 layers unrolled: mamba + MoE, then sliding
attention + SwiGLU; 8 layers scanned as plan (0, 2, 4, 0)) with the
reference's own weights: a 128-token forward, a 128-token prefill with its
cache (twice the attention window of 64, so the ring wraps), 4 decode
steps with their cache, greedy ``generate``. The port takes those weights
through ``convert.lm_params_from_reference`` and runs on the CPU, where
the mamba_scan, flash and router kernels' wrappers run their plain
versions.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in other
orders (the port's doubling scan against ``lax.associative_scan``, the
matrix products), ≈ 1e-6 at these widths; a missing or misplaced term
(the skip D, one step's decay, the conv bias, a gate) moves the outputs
by ≥ 1e-3. Greedy tokens are held EQUAL. The MoE layers route exactly as
the reference only away from near-ties of the router's probabilities, so
the model tests assert that the smallest gap between the k-th and
(k+1)-th probability of every routed token is above 1e-5, ≥ 100× the two
packages' rounding of a float32 probability (≈ 1e-7), the margin
``chip_smoke.py`` allows a routing flip below. (The 2-layer prompts hold
one token at a gap of 1.8e-5, under the moonshot tests' 1e-4.)
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm_ref import (B, JAMBA_MAX_LEN, JAMBA_PROMPT, MAMBA_CHUNK,
                           MAMBA_D, MAMBA_STATE, NEW, STEPS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba, moe, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
SMOKE = "jamba-v0.1-52b-smoke"
SPEC = mamba.MambaSpec(d_model=MAMBA_D, d_state=MAMBA_STATE)
MODELS = [pytest.param(2, id="2-unrolled"), pytest.param(8, id="8-scanned")]
MIN_MARGIN = 1e-5


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mamba_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "mamba"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def margins(monkeypatch):
    """Records, for every ``moe_block`` the model calls, the smallest gap
    between the k-th and (k+1)-th router probability of its tokens."""
    seen = []
    block = moe.moe_block

    def recording(params, spec, x, **kw):
        logits = moe._router_logits(params, x.reshape(-1, x.shape[-1]))
        p = torch.sort(torch.softmax(logits.double(), dim=-1), dim=-1,
                       descending=True).values
        k = spec.experts_per_token
        seen.append((p[:, k - 1] - p[:, k]).min().item())
        return block(params, spec, x, **kw)

    monkeypatch.setattr(moe, "moe_block", recording)
    return seen


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def tree(ref, prefix):
    """The dump's leaves under ``prefix`` as nested dicts of tensors."""
    return convert._nest(ref, prefix, None, torch.device("cpu"))


def cfg_of(n_layers):
    return dataclasses.replace(get_config(SMOKE), num_layers=n_layers)


def port_params(ref, n_layers):
    flat = {k[len(f"jamba{n_layers}/params/"):]: a for k, a in ref.items()
            if k.startswith(f"jamba{n_layers}/params/")}
    return convert.lm_params_from_reference(flat, cfg_of(n_layers),
                                            device="cpu")


def reference_layer_cache(ref, prefix, cfg, i, leaf):
    """Layer i's ``leaf`` (e.g. "mamba/h", "kv/k") from the reference's
    head/scan/tail cache."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    if n_rep == 1 or i < head:
        return ref[f"{prefix}/head/{i}/{leaf}"]
    r, j = divmod(i - head, period)
    return ref[f"{prefix}/scan/{j}/{leaf}"][r]


def check_layer_caches(ref, prefix, cfg, cache):
    for i, ls in enumerate(cfg.layer_specs()):
        c = cache["layers"][i]
        if ls.mixer == "mamba":
            assert set(c) == {"mamba"}
            for leaf in ("h", "conv"):
                close(c["mamba"][leaf],
                      reference_layer_cache(ref, prefix, cfg, i,
                                            f"mamba/{leaf}"))
        else:
            assert set(c) == {"kv"}
            for leaf in ("k", "v"):
                close(c["kv"][leaf],
                      reference_layer_cache(ref, prefix, cfg, i,
                                            f"kv/{leaf}"))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_ssm_inputs_and_causal_conv_match_reference(ref):
    params = tree(ref, "block/params")
    xin, z = mamba._ssm_inputs(params, SPEC, t(ref["block/x"]))
    close(xin, ref["ssm_inputs/x"])
    close(z, ref["ssm_inputs/z"])
    close(mamba._causal_conv(params, SPEC, xin), ref["causal_conv/out"])


def test_selective_terms_match_reference(ref):
    decay, drive, c = mamba._selective_terms(
        tree(ref, "block/params"), SPEC, t(ref["causal_conv/out"]))
    close(decay, ref["selective/decay"])
    close(drive, ref["selective/drive"])
    close(c, ref["selective/c"])


@pytest.mark.parametrize("scan", [mamba.mamba_scan_ref, kref.mamba_scan_ref,
                                  ms.mamba_scan],
                         ids=["associative", "sequential", "wrapper"])
def test_scans_match_reference(ref, scan):
    """The associative form, the kernel's plain version and the kernel's
    wrapper (on the CPU: the plain version) give the reference's h."""
    ms.KERNEL.launches = 0
    h = scan(t(ref["selective/decay"]), t(ref["selective/drive"]))
    assert ms.KERNEL.launches == 0
    close(h, ref["scan/h"])


def test_associative_scan_carries_the_cumulative_decay(ref):
    decay = t(ref["selective/decay"]).double()
    cumdec, _ = mamba.associative_scan(decay, t(ref["selective/drive"]))
    np.testing.assert_allclose(cumdec.numpy(),
                               torch.cumprod(decay, dim=1).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("chunk", [1024, MAMBA_CHUNK], ids=["whole",
                                                            "chunked"])
def test_mamba_block_matches_reference(ref, chunk):
    out = mamba.mamba_block(tree(ref, "block/params"), SPEC,
                            t(ref["block/x"]), chunk=chunk)
    close(out, ref["block/out" if chunk > 48 else "block/out_chunked"])


def test_mamba_block_chunk_must_divide_the_sequence(ref):
    with pytest.raises(ValueError, match="not divisible by chunk"):
        mamba.mamba_block(tree(ref, "block/params"), SPEC,
                          t(ref["block/x"]), chunk=20)


@pytest.mark.parametrize("s", [40, 2], ids=["prompt", "shorter_than_ring"])
def test_mamba_prefill_matches_reference(ref, s):
    cache = mamba.init_mamba_cache(B, SPEC, torch.float32, "cpu")
    ms.KERNEL.launches = 0
    y, c = mamba.mamba_prefill(tree(ref, "block/params"), SPEC,
                               t(ref["block/x"])[:, :s], cache)
    assert ms.KERNEL.launches == 0          # the CPU runs the plain version
    close(y, ref[f"prefill{s}/out"])
    close(c["h"], ref[f"prefill{s}/cache/h"])
    close(c["conv"], ref[f"prefill{s}/cache/conv"])


def test_mamba_decode_steps_match_reference(ref):
    params = tree(ref, "block/params")
    x = t(ref["block/x"])
    _, c = mamba.mamba_prefill(params, SPEC, x[:, :40],
                               mamba.init_mamba_cache(B, SPEC, torch.float32,
                                                      "cpu"))
    ys = []
    for step in range(40, 44):
        y, c = mamba.mamba_decode(params, SPEC, x[:, step:step + 1], c)
        ys.append(y)
    close(torch.cat(ys, dim=1), ref["decode/out"])
    close(c["h"], ref["decode/cache/h"])
    close(c["conv"], ref["decode/cache/conv"])


def test_softplus_matches_jax_above_torchs_threshold():
    """``jax.nn.softplus`` is log(1 + eˣ) everywhere; torch's ``F.softplus``
    returns x above 20. The port follows jax."""
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 25.0], dtype=torch.float64)
    np.testing.assert_allclose(mamba._softplus(x).numpy(),
                               np.logaddexp(x.numpy(), 0.0), rtol=1e-15)


def test_decode_equals_own_block():
    """The counterpart of the reference's own test (tests/test_models.py,
    ``test_mamba_decode_matches_prefill``): 24 decode steps through the
    kernel's route equal the full block through the associative scan."""
    spec = mamba.MambaSpec(d_model=32, d_state=8)
    p = mamba.mamba_init(torch.Generator().manual_seed(0), spec,
                         torch.float32)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 24, 32)),
                        dtype=torch.float32)
    full = mamba.mamba_block(p, spec, x)
    c = mamba.init_mamba_cache(1, spec, torch.float32, "cpu")
    outs = []
    for step in range(24):
        o, c = mamba.mamba_decode(p, spec, x[:, step:step + 1], c)
        outs.append(o)
    close(torch.cat(outs, 1), full.numpy())
    y, cp = mamba.mamba_prefill(p, spec, x, mamba.init_mamba_cache(
        1, spec, torch.float32, "cpu"))
    close(y, full.numpy())
    close(cp["h"], c["h"].numpy())
    close(cp["conv"], c["conv"].numpy())


def test_terms_compute_in_float64_for_float64(ref):
    """A float64 mixer computes Δ, B, C, the scan and the skip in float64
    (the reference casts them to float32 whatever the dtype): the float64
    forward on the card is a float64 reference."""
    params = {k: v.double() for k, v in tree(ref, "block/params").items()}
    x = t(ref["block/x"]).double()
    decay, drive, c = mamba._selective_terms(params, SPEC, x @ params["in_x"])
    assert decay.dtype == drive.dtype == c.dtype == torch.float64
    assert mamba.mamba_block(params, SPEC, x).dtype == torch.float64
    out32 = mamba.mamba_block(tree(ref, "block/params"), SPEC,
                              t(ref["block/x"]))
    close(out32, mamba.mamba_block(params, SPEC, x).numpy())


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", MODELS)
def test_convert_unstacks_reference_layout(ref, n_layers):
    cfg = cfg_of(n_layers)
    params = port_params(ref, n_layers)
    plan = transformer.stack_plan(cfg)
    assert plan == ((0, 2, 1, 0) if n_layers == 2 else (0, 2, 4, 0))
    assert len(params["layers"]) == n_layers
    for i, (lay, ls) in enumerate(zip(params["layers"], cfg.layer_specs())):
        mixer = "mamba" if ls.mixer == "mamba" else "attn"
        ffn = "moe" if ls.ffn == "moe" else "ffn"
        assert set(lay) == {"norm1", "norm2", mixer, ffn}
        names = (("mamba/in_x", "mamba/conv_w", "mamba/x_proj",
                  "mamba/dt_bias", "mamba/A_log", "mamba/D",
                  "mamba/out_proj", "moe/router", "moe/w_down")
                 if mixer == "mamba" else ("attn/wq", "attn/wo", "ffn/w_up"))
        for name in names:
            r, j = divmod(i, 2)
            key = (f"jamba{n_layers}/params/layers_head/{i}/{name}"
                   if n_layers == 2 else
                   f"jamba{n_layers}/params/layers_scan/{j}/{name}")
            want = ref[key] if n_layers == 2 else ref[key][r]
            node = lay
            for part in name.split("/"):
                node = node[part]
            assert np.array_equal(node.numpy(), want)


@pytest.mark.parametrize("n_layers", MODELS)
def test_forward_matches_reference(ref, n_layers, margins):
    ms.KERNEL.launches = mr.KERNEL.launches = 0
    logits = transformer.forward(
        port_params(ref, n_layers), cfg_of(n_layers),
        {"tokens": t(ref[f"jamba{n_layers}/forward_tokens"]).long()})
    assert ms.KERNEL.launches == mr.KERNEL.launches == 0
    close(logits, ref[f"jamba{n_layers}/forward_logits"])
    assert len(margins) == n_layers // 2 and min(margins) > MIN_MARGIN


@pytest.mark.parametrize("n_layers", MODELS)
def test_prefill_and_decode_steps_match_reference(ref, n_layers, margins):
    cfg, p = cfg_of(n_layers), f"jamba{n_layers}"
    params = port_params(ref, n_layers)
    cache = transformer.init_cache(cfg, B, JAMBA_MAX_LEN, torch.float32,
                                   "cpu")
    fa.KERNEL.launches = ms.KERNEL.launches = mr.KERNEL.launches = 0
    last, cache = transformer.prefill(
        params, cfg, {"tokens": t(ref[f"{p}/prompts"]).long()}, cache)
    close(last, ref[f"{p}/prefill_logits"])
    check_layer_caches(ref, f"{p}/prefill_cache", cfg, cache)
    steps = t(ref[f"{p}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), JAMBA_PROMPT + i, dtype=torch.long))
        close(logits, ref[f"{p}/decode_logits"][i])
    check_layer_caches(ref, f"{p}/decode_cache", cfg, cache)
    # the CPU runs the plain versions
    assert fa.KERNEL.launches == ms.KERNEL.launches == mr.KERNEL.launches == 0
    assert min(margins) > MIN_MARGIN


@pytest.mark.parametrize("n_layers", MODELS)
def test_greedy_generate_equals_reference(ref, n_layers, margins):
    p = f"jamba{n_layers}"
    engine = ServeEngine(cfg_of(n_layers), port_params(ref, n_layers),
                         max_len=JAMBA_MAX_LEN, device="cpu")
    out = engine.generate(ref[f"{p}/prompts"], new_tokens=NEW)
    np.testing.assert_array_equal(out, ref[f"{p}/generate_tokens"])
    assert min(margins) > MIN_MARGIN


def test_decode_equals_own_prefill():
    """The model's decode steps give the logits its full forward and its
    prefill give at the same positions, past the attention window. The
    forward routes the MoE in groups of one token: with a capacity factor
    of 2 no choice is dropped in a group of 64 or of 1, so the grouping
    changes nothing and prompt and decode positions compare alike."""
    cfg = dataclasses.replace(get_config(SMOKE), moe_capacity_factor=2.0)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 132),
                           generator=torch.Generator().manual_seed(4))
    full = transformer.forward(params, dataclasses.replace(
        cfg, moe_group_size=1), {"tokens": tokens})
    cache = transformer.init_cache(cfg, 2, 132, torch.float32, "cpu")
    last, cache = transformer.prefill(params, cfg,
                                      {"tokens": tokens[:, :128]}, cache)
    close(last, full[:, 127].numpy())
    for i in range(128, 132):
        logits, cache = transformer.decode_step(
            params, cfg, tokens[:, i:i + 1], cache,
            torch.full((2,), i, dtype=torch.long))
        close(logits[:, 0], full[:, i].numpy())


def test_launcher_serves_jamba_on_cpu(capsys):
    launch_serve.main(["--arch", SMOKE, "--batch", "2", "--prompt-len", "128",
                       "--new-tokens", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_mamba_cache_has_the_references_leaves():
    cfg = get_config(SMOKE)
    cache = transformer.init_cache(cfg, 3, 8, torch.float32, "cpu")
    spec = transformer.mamba_spec(cfg)
    c = cache["layers"][0]
    assert set(c) == {"mamba"}
    assert c["mamba"]["h"].shape == (3, spec.d_inner, spec.d_state)
    assert c["mamba"]["h"].dtype == torch.float32
    assert c["mamba"]["conv"].shape == (3, spec.d_conv - 1, spec.d_inner)
    assert set(cache["layers"][1]) == {"kv"}
    assert cache["layers"][1]["kv"]["k"].shape[1] == 8    # min(8, window)


def test_prefill_cache_holds_copies_not_views_of_the_activations():
    """The cache's SSM state and conv ring are tensors of their own: a
    view of the last step would keep each mamba layer's whole (B, S, di,
    ds) state, or its (B, S, di) input, alive."""
    cfg = get_config(SMOKE)
    spec = transformer.mamba_spec(cfg)
    params = transformer.init_params(cfg, seed=5, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(6))
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, "cpu")
    _, cache = transformer.prefill(params, cfg, {"tokens": tokens}, cache)
    c = cache["layers"][0]["mamba"]
    assert c["h"].untyped_storage().nbytes() == 2 * spec.d_inner \
        * spec.d_state * 4
    assert c["conv"].untyped_storage().nbytes() == 2 * (spec.d_conv - 1) \
        * spec.d_inner * 4
    assert c["h"].is_contiguous() and c["conv"].is_contiguous()
