"""The port's LM serving slices against the JAX reference.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs ``tests/_torch_lm_ref.py`` once in a
subprocess and loads the npz it writes: the reference's weights for
mistral-nemo-12b-smoke at 2 layers (unrolled) and 4 layers (scanned) and
for moonshot-v1-16b-a3b-smoke (a dense layer, then MoE layers of 4
experts, top-2) at 2 layers (unrolled) and 6 layers (scanned as one dense
head layer and one MoE layer 5 times), mistral-nemo-12b-smoke at 2 layers
with an untied unembedding (its weights, forward logits and loss), its
building blocks on fixed inputs, ``prefill_attention`` and
``decode_attention`` with their caches, ``transformer.forward``,
``prefill`` and 4 teacher-forced ``decode_step`` logits, and greedy
``ServeEngine.generate`` tokens. The port takes the reference's weights
through ``convert.lm_params_from_reference`` and runs on the CPU, where
the flash kernel's wrapper runs its plain version.

Tolerance: rtol = atol = 2e-5 for every float output (logits included).
Both sides compute in float32 but sum in other orders (XLA's CPU
reductions and dot products against PyTorch's), which moves the outputs by
≈ 1e-6 at these widths; 2e-5 leaves a margin of 10 while staying far below
any change of the computation (a missing mask, scale or RoPE term moves
them by ≥ 1e-2). Greedy tokens are held EQUAL. The MoE layers route
exactly as the reference only away from near-ties of the router's
probabilities, so the moonshot tests assert that the smallest gap between
the k-th and (k+1)-th probability of every routed token is above 1e-4,
≥ 1000× the two packages' rounding of a float32 probability.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro_torch import convert
from repro_torch.configs import available_archs, get_config
from repro_torch.configs.base import ModelConfig, port_only_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_router as mr
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.serve import ServeEngine

TOL = dict(rtol=2e-5, atol=2e-5)
TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
B, PROMPT, NEW, STEPS, MAX_LEN = 2, 8, 6, 4, 16
SMOKE = "mistral-nemo-12b-smoke"
MOON = "moonshot-v1-16b-a3b-smoke"
PORTED = {"mistral-nemo-12b", SMOKE, "phi3-medium-14b",
          "phi3-medium-14b-smoke", "moonshot-v1-16b-a3b", MOON, "rwkv6-7b",
          "rwkv6-7b-smoke", "jamba-v0.1-52b", "jamba-v0.1-52b-smoke",
          "gemma3-4b", "gemma3-4b-smoke", "llama4-scout-17b-a16e",
          "llama4-scout-17b-a16e-smoke", "llama4-maverick-400b-a17b",
          "llama4-maverick-400b-a17b-smoke", "whisper-tiny",
          "whisper-tiny-smoke", "llava-next-mistral-7b",
          "llava-next-mistral-7b-smoke"}
# the registry's archs that the reference does not have
PORT_ONLY = {"moonlight-16b-a3b", "moonlight-16b-a3b-smoke"}
# (arch, layers) of the reference's dumps; mistral's keep their ids
MODELS = [pytest.param(SMOKE, 2, id="2"), pytest.param(SMOKE, 4, id="4"),
          pytest.param(MOON, 2, id="moonshot-2"),
          pytest.param(MOON, 6, id="moonshot-6")]
MIN_MARGIN = 1e-4


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def sub(ref, prefix):
    return {k[len(prefix) + 1:]: a for k, a in ref.items()
            if k.startswith(prefix + "/")}


def key(arch, n_layers):
    """The dump's prefix of ``arch`` at ``n_layers``."""
    return f"p{n_layers}" if arch == SMOKE else f"moon{n_layers}"


def cfg_of(n_layers, arch=SMOKE):
    return dataclasses.replace(get_config(arch), num_layers=n_layers)


def port_params(ref, n_layers, arch=SMOKE):
    return convert.lm_params_from_reference(
        sub(ref, f"{key(arch, n_layers)}/params"), cfg_of(n_layers, arch),
        device="cpu")


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


def check_margins(arch, seen):
    if arch == MOON:
        assert seen and min(seen) > MIN_MARGIN, min(seen)
    else:
        assert not seen


def reference_layer_cache(ref, prefix, cfg, i):
    """Layer i's k and v from the reference's head/scan/tail cache."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    if n_rep == 1 or i < head:
        return (ref[f"{prefix}/head/{i}/kv/k"], ref[f"{prefix}/head/{i}/kv/v"])
    r, j = divmod(i - head, period)
    return (ref[f"{prefix}/scan/{j}/kv/k"][r], ref[f"{prefix}/scan/{j}/kv/v"][r])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PORTED))
def test_config_equals_reference(name):
    port, want = get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    assert ([dataclasses.asdict(s) for s in port.layer_specs()]
            == [dataclasses.asdict(s) for s in want.layer_specs()])
    assert port.count_params() == want.count_params()


def test_registry_holds_only_ported_archs():
    """The reference's archs the port has, and the port-only ones (no
    reference config), each set apart."""
    assert port_only_archs() == sorted(PORT_ONLY)
    assert set(available_archs()) == PORTED | PORT_ONLY
    assert not PORT_ONLY & set(ref_configs.available_archs())
    assert get_config("mistral-nemo-12b").count_params() == 11_576_688_640
    moon = get_config("moonshot-v1-16b-a3b")
    assert moon.count_params() == 27_177_320_448
    assert [s.ffn for s in moon.layer_specs()] == ["swiglu"] + ["moe"] * 47
    rwkv = get_config("rwkv6-7b")
    assert rwkv.count_params() == 7_264_796_672
    assert {(s.mixer, s.ffn) for s in rwkv.layer_specs()} == {
        ("rwkv", "rwkv_channel")}
    assert transformer.stack_plan(rwkv) == (0, 1, 32, 0)
    jamba = get_config("jamba-v0.1-52b")
    assert jamba.count_params() == 51_301_416_960
    assert [(s.mixer, s.ffn) for s in jamba.layer_specs()[:8]] == [
        ("mamba", "moe"), ("mamba", "swiglu")] * 3 + [
        ("mamba", "moe"), ("attn_sliding", "swiglu")]
    assert transformer.stack_plan(jamba) == (0, 8, 4, 0)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", [n for n in ref_configs.available_archs()
                                  if n not in PORTED])
def test_unported_arch_raises_naming_its_slice(name):
    with pytest.raises(NotImplementedError, match="slice"):
        get_config(name)


UNTIED = dataclasses.replace(get_config(SMOKE), num_layers=2,
                             tie_embeddings=False)


@pytest.mark.parametrize("part", ["init", "forward", "loss"])
def test_untied_unembedding_matches_reference(ref, part):
    """The reference's untied branch (``lm_head`` (D, V), ``x @
    lm_head``), ported: the port's ``init_params`` makes the reference's
    leaves at its shapes, ``lm_head`` a fan-in truncated normal; on the
    reference's weights the forward's logits and ``loss_fn`` agree."""
    flat = sub(ref, "untied/params")
    params = convert.lm_params_from_reference(flat, UNTIED, device="cpu")
    batch = {"tokens": t(ref["untied/tokens"])}
    if part == "init":
        port = transformer.init_params(UNTIED, seed=0, device="cpu")
        mine = convert.lm_params_to_reference(port, UNTIED)
        assert {k: a.shape for k, a in mine.items()} == \
            {k: a.shape for k, a in flat.items()}
        head, want = port["lm_head"], flat["lm_head"]
        assert head.shape == (UNTIED.d_model, UNTIED.vocab_size)
        assert abs(float(head.std()) / float(np.std(want)) - 1) < 0.05
        assert float(head.abs().max()) <= 2.0 / UNTIED.d_model ** 0.5 * (
            1 + 1e-6)
        assert not torch.equal(head, port["embed"].T)
    elif part == "forward":
        close(transformer.forward(params, UNTIED, batch),
              ref["untied/forward_logits"])
    else:
        close(transformer.loss_fn(params, UNTIED,
                                  dict(batch, labels=batch["tokens"])),
              ref["untied/loss"])


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_norms_match_reference(ref):
    x, scale = t(ref["rmsnorm/x"]), t(ref["rmsnorm/scale"])
    close(layers.rmsnorm({"scale": scale}, x), ref["rmsnorm/out"])
    close(layers.layernorm({"scale": t(ref["layernorm/scale"]),
                            "bias": t(ref["layernorm/bias"])}, x),
          ref["layernorm/out"])


def test_apply_rope_matches_reference(ref):
    cfg = get_config(SMOKE)
    got = layers.apply_rope(t(ref["rope/x"]), t(ref["rope/positions"]),
                            cfg.rope_theta)
    close(got, ref["rope/out"])


def test_mlps_match_reference(ref):
    x = t(ref["rmsnorm/x"])
    params = port_params(ref, 2)
    close(layers.swiglu(params["layers"][0]["ffn"], x), ref["swiglu/out"])
    gelu = {k: t(a) for k, a in sub(ref, "gelu/params").items()}
    close(layers.gelu_mlp(gelu, x), ref["gelu/out"])


def test_prefill_and_decode_attention_match_reference(ref):
    cfg = cfg_of(2)
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[0])
    p = port_params(ref, 2)["layers"][0]["attn"]
    kv = attention.init_kv_cache(B, spec, MAX_LEN - 4, torch.float32, "cpu")
    y, kv = attention.prefill_attention(p, spec, t(ref["prefill_attention/x"]),
                                        torch.arange(PROMPT), kv)
    close(y, ref["prefill_attention/out"])
    close(kv["k"], ref["prefill_attention/k"])
    close(kv["v"], ref["prefill_attention/v"])
    y, kv = attention.decode_attention(p, spec, t(ref["decode_attention/x"]),
                                       kv, t(ref["decode_attention/pos"]).long())
    close(y, ref["decode_attention/out"])
    close(kv["k"], ref["decode_attention/k"])
    close(kv["v"], ref["decode_attention/v"])


def test_prefill_checks_positions_and_cache_length():
    cfg = get_config(SMOKE)
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[0])
    p = transformer.init_params(cfg, device="cpu")["layers"][0]["attn"]
    x = torch.zeros(1, 6, cfg.d_model)
    with pytest.raises(ValueError, match="decode-equivalent"):
        attention.prefill_attention(
            p, spec, x, torch.arange(6),
            attention.init_kv_cache(1, spec, 4, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="arange"):
        attention.prefill_attention(
            p, spec, x, torch.arange(1, 7),
            attention.init_kv_cache(1, spec, 8, torch.float32, "cpu"))


def test_prefill_attention_reads_nothing_back_from_the_device(monkeypatch):
    """Prefill's attention makes no call that copies a tensor to the host
    (on the card each would wait for it): ``Tensor.cpu``, ``.item`` and
    ``.tolist`` raise while it runs."""
    cfg = get_config(SMOKE)
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[0])
    p = transformer.init_params(cfg, device="cpu")["layers"][0]["attn"]
    x = torch.randn(2, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    kv = attention.init_kv_cache(2, spec, 8, torch.float32, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a read back from the device")

    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y, kv = attention.prefill_attention(p, spec, x, torch.arange(6), kv)
    monkeypatch.undo()
    assert y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("positions", [torch.arange(1, 7), torch.arange(7),
                                       torch.arange(6)[None]],
                         ids=["shifted", "longer", "batched"])
def test_full_sequence_attention_rejects_positions_not_arange(positions):
    cfg = get_config(SMOKE)
    spec = transformer.attn_spec(cfg, cfg.layer_specs()[0])
    p = transformer.init_params(cfg, device="cpu")["layers"][0]["attn"]
    x = torch.zeros(1, 6, cfg.d_model)
    with pytest.raises(ValueError, match="arange"):
        attention.attention_block(p, spec, x, positions)
    with pytest.raises(ValueError, match="arange"):
        attention.prefill_attention(
            p, spec, x, positions,
            attention.init_kv_cache(1, spec, 8, torch.float32, "cpu"))


def test_init_statistics():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (1024, 512), torch.float32)
    scale = 1024 ** -0.5
    assert w.abs().max() <= 2 * scale
    # a standard normal cut to ±2 has sd 0.8796
    assert abs(w.std().item() / scale - 0.8796) < 0.005
    assert abs(w.mean().item()) < 0.005 * scale
    e = layers.embed_init(gen, 1024, 512, torch.float32)
    assert abs(e.std().item() - 0.02) < 2e-4 and abs(e.mean().item()) < 2e-4


# ---------------------------------------------------------------------------
# the model and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_convert_unstacks_reference_layout(ref, arch, n_layers):
    params = port_params(ref, n_layers, arch)
    cfg, p = cfg_of(n_layers, arch), key(arch, n_layers)
    assert len(params["layers"]) == n_layers
    plan = transformer.stack_plan(cfg)
    head, _, n_rep, _ = plan
    assert (n_rep == 1) == (n_layers == 2)
    if arch == MOON:
        assert plan == ((0, 2, 1, 0) if n_layers == 2 else (1, 1, 5, 0))

    def leaf(i, name):
        """Layer i's leaf ``name`` in the reference's layout."""
        if n_rep == 1 or i < head:
            return ref[f"{p}/params/layers_head/{i}/{name}"]
        return ref[f"{p}/params/layers_scan/0/{name}"][i - head]

    for i, (lay, ls) in enumerate(zip(params["layers"], cfg.layer_specs())):
        assert np.array_equal(lay["attn"]["wq"].numpy(), leaf(i, "attn/wq"))
        assert lay["attn"]["wo"].shape == (4, 64, 256)
        assert ("moe" in lay) == (ls.ffn == "moe")
        for name in (("router", "w_gate", "w_up", "w_down")
                     if ls.ffn == "moe" else ()):
            assert np.array_equal(lay["moe"][name].numpy(),
                                  leaf(i, f"moe/{name}"))


@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_forward_matches_reference(ref, arch, n_layers, margins):
    params, p = port_params(ref, n_layers, arch), key(arch, n_layers)
    mr.KERNEL.launches = 0
    logits = transformer.forward(
        params, cfg_of(n_layers, arch),
        {"tokens": t(ref[f"{p}/forward_tokens"]).long()})
    assert mr.KERNEL.launches == 0
    close(logits, ref[f"{p}/forward_logits"])
    check_margins(arch, margins)


@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_prefill_and_decode_steps_match_reference(ref, arch, n_layers,
                                                  margins):
    cfg, p = cfg_of(n_layers, arch), key(arch, n_layers)
    params = port_params(ref, n_layers, arch)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    fa.KERNEL.launches = mr.KERNEL.launches = 0
    last, cache = transformer.prefill(params, cfg,
                                      {"tokens": t(ref[f"{p}/prompts"]).long()},
                                      cache)
    # the CPU runs the plain versions
    assert fa.KERNEL.launches == mr.KERNEL.launches == 0
    close(last, ref[f"{p}/prefill_logits"])
    for i in range(n_layers):
        k, v = reference_layer_cache(ref, f"{p}/prefill_cache", cfg, i)
        close(cache["layers"][i]["kv"]["k"], k)
        close(cache["layers"][i]["kv"]["v"], v)
    steps = t(ref[f"{p}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), PROMPT + i, dtype=torch.long))
        close(logits, ref[f"{p}/decode_logits"][i])
    for i in range(n_layers):
        k, v = reference_layer_cache(ref, f"{p}/decode_cache", cfg, i)
        close(cache["layers"][i]["kv"]["k"], k)
        close(cache["layers"][i]["kv"]["v"], v)
    check_margins(arch, margins)


@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_greedy_generate_equals_reference(ref, arch, n_layers, margins):
    p = key(arch, n_layers)
    engine = ServeEngine(cfg_of(n_layers, arch),
                         port_params(ref, n_layers, arch), max_len=MAX_LEN,
                         device="cpu")
    out = engine.generate(ref[f"{p}/prompts"], new_tokens=NEW)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref[f"{p}/generate_tokens"])
    check_margins(arch, margins)


def test_sampling_draws_from_the_generator():
    cfg = get_config(SMOKE)
    engine = ServeEngine(cfg, transformer.init_params(cfg, device="cpu"),
                         device="cpu")
    prompts = np.arange(2 * 5).reshape(2, 5)

    def sample(seed):
        return engine.generate(prompts, new_tokens=5, temperature=1.0,
                               generator=torch.Generator().manual_seed(seed))

    np.testing.assert_array_equal(sample(1), sample(1))
    assert not np.array_equal(sample(1), sample(2))
    greedy = engine.generate(prompts, new_tokens=5)
    np.testing.assert_array_equal(
        greedy, engine.generate(prompts, new_tokens=5, temperature=1.0))


def test_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--arch", SMOKE, "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "3", "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_launcher_serves_moonshot_on_cpu(capsys):
    launch_serve.main(["--arch", MOON, "--batch", "2", "--prompt-len", "16",
                       "--new-tokens", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_traced_generate_equals_untraced(tmp_path):
    """``ServeEngine(trace=path)``: the tokens equal an untraced engine's,
    the trace validates, and it holds a ``prefill`` and a ``decode`` span
    per call (the tokens' one transfer inside ``decode``) and the two rate
    events. The engine owns a trace it opened; a caller's ``Trace`` stays
    open after ``close()``."""
    from repro_torch.obs import Trace, validate_trace
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=2, device="cpu")
    prompts = np.arange(2 * 6).reshape(2, 6) % cfg.vocab_size
    plain = ServeEngine(cfg, params, device="cpu").generate(prompts, 4)
    path = tmp_path / "serve.jsonl"
    engine = ServeEngine(cfg, params, device="cpu", trace=str(path))
    for _ in range(2):
        np.testing.assert_array_equal(engine.generate(prompts, 4), plain)
    engine.close()
    assert validate_trace(path) == []
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert recs[0]["name"] == f"serve:{cfg.name}"
    assert recs[0]["backend"] == "cpu"
    spans = [(r["name"], r.get("attrs")) for r in recs if r["kind"] == "span"]
    assert spans == [("prefill", {"batch": 2, "prompt_tokens": 12}),
                     ("decode", {"batch": 2, "new_tokens": 4})] * 2
    assert [r["transfers"] for r in recs if r["kind"] == "span"] == \
        [0, 1] * 2
    events = [r for r in recs if r["kind"] == "event"]
    assert [e["name"] for e in events] == ["prefill.rate",
                                           "decode.rate"] * 2
    assert all(e["attrs"]["tok_per_s"] > 0 for e in events)
    assert [e["attrs"]["tokens"] for e in events[:2]] == [12, 8]

    shared = Trace(tmp_path / "shared.jsonl", name="caller")
    engine = ServeEngine(cfg, params, device="cpu", trace=shared)
    engine.generate(prompts, 2)
    engine.close()
    assert shared.active
    shared.close()
    assert validate_trace(tmp_path / "shared.jsonl") == []


def test_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for GPU-less hosts")
    cfg = get_config(SMOKE)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, transformer.init_params(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", SMOKE, "--prompt-len", "4"])


def test_engine_refuses_params_on_another_device_or_dtype():
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        ServeEngine(cfg, params, device="cpu")


def test_model_config_is_the_ports_own():
    assert ModelConfig.__module__ == "repro_torch.configs.base"
