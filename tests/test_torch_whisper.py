"""The port's whisper-tiny slice (the encoder-decoder: a non-causal
encoder over the audio frontend's frames, cross attention in every
decoder layer, learned positions, LayerNorm and GELU) against the JAX
reference's ``repro.models``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``frontends`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: ``attention_block`` with ``kv_x`` (cross attention, 10 queries
over 24 keys) and non-causal, at whisper-tiny-smoke's widths (4 heads of
32, no RoPE) and at llava-next-mistral-7b-smoke's (4/2 heads of 64, RoPE
on each side at its own positions); and whisper-tiny-smoke with the
reference's own weights and 64 frames (its ``encoder_seq``) at 2 decoder
layers (unrolled) and 4 (scanned as plan (0, 1, 4, 0), the cross weights
stacked with the rest): its forward, prefill with its cache (the encoder's
output and the KV slots), 4 teacher-forced decode steps with their cache,
and greedy ``ServeEngine.generate`` with the reference's frames injected
through ``extra_batch``. The port takes those weights through
``convert.lm_params_from_reference`` and runs on the CPU, where the flash
kernel's wrapper runs its plain version.

Tolerance: rtol = atol = 2e-5 for every float output, as in
``tests/test_torch_lm.py``: both sides compute in float32 and sum in other
orders (≈ 1e-6 at these widths); a missing cross block, a causal mask on
the encoder or a position table off by one moves the outputs by ≥ 1e-3.
Greedy tokens are held EQUAL.
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
from _torch_lm_ref import (B, CROSS_SK, CROSS_SQ, FRONT_ARCHS, MAX_LEN, NEW,
                           PROMPT, STEPS, WHISPER_LAYERS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, frontends, transformer
from repro_torch.serve import ServeEngine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
WHISPER = "whisper-tiny"
NAMES = [WHISPER, WHISPER + "-smoke"]


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


def sub(ref, prefix):
    return {k[len(prefix) + 1:]: a for k, a in ref.items()
            if k.startswith(prefix + "/")}


def cfg_of(n_layers):
    return dataclasses.replace(get_config(FRONT_ARCHS["whisper"]),
                               num_layers=n_layers)


def port_params(front, n_layers):
    return convert.lm_params_from_reference(
        sub(front, f"whisper{n_layers}/params"), cfg_of(n_layers),
        device="cpu")


def frames_of(front, n_layers):
    return t(front[f"whisper{n_layers}/frames"])


def layer_kv(front, prefix, cfg, i, leaf):
    """Layer i's cache ``leaf`` from the reference's head/scan layout."""
    head, period, n_rep, _ = transformer.stack_plan(cfg)
    if n_rep == 1:
        return front[f"{prefix}/head/{i}/kv/{leaf}"]
    r, j = divmod(i - head, period)
    return front[f"{prefix}/scan/{j}/kv/{leaf}"][r]


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
    cfg = get_config(WHISPER)
    assert cfg.count_params() == 38_805_888
    assert (cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq,
            cfg.head_dim, cfg.max_position) == (4, 4, 1500, 64, 32768)
    assert (cfg.learned_pos, cfg.use_rope, cfg.norm, cfg.ffn_kind) == (
        True, False, "layernorm", "gelu")
    assert {(s.mixer, s.ffn) for s in cfg.layer_specs()} == {
        ("attn_full", "gelu")}
    assert transformer.stack_plan(cfg) == (0, 1, 4, 0)
    assert transformer.stack_plan(cfg_of(2)) == (0, 2, 1, 0)


def test_init_params_hold_the_encoder_and_the_cross_blocks():
    cfg = get_config(WHISPER + "-smoke")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    assert params["pos_embed"].shape == (cfg.max_position, cfg.d_model)
    assert params["enc_pos_embed"].shape == (cfg.encoder_seq, cfg.d_model)
    assert len(params["enc_layers"]) == cfg.encoder_layers
    assert all("cross" not in lay for lay in params["enc_layers"])
    for lay in params["layers"]:
        assert lay["cross"]["wq"].shape == (cfg.d_model, cfg.num_heads,
                                            cfg.head_dim)
        assert set(lay["norm_cross"]) == {"scale", "bias"}


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cross", "noncausal"])
@pytest.mark.parametrize("name", sorted(FRONT_ARCHS))
def test_attention_block_with_kv_x_matches_reference(front, name, kind):
    """The plain block and the kernel path (the plain version on the CPU)
    both equal the reference's ``attention_block``."""
    cfg = get_config(FRONT_ARCHS[name])
    spec = transformer._cross_spec(cfg)
    params = convert._nest(front, f"attn_{name}/params", None,
                           torch.device("cpu"))
    x, kv = t(front[f"attn_{name}/x"]), t(front[f"attn_{name}/kv_x"])
    if kind == "cross":
        args = (x, torch.arange(CROSS_SQ))
        kw = dict(kv_x=kv, kv_positions=torch.arange(CROSS_SK))
    else:
        args, kw = (kv, torch.arange(CROSS_SK)), {}
    for block in (attention.attention_block, attention.kernel_attention):
        close(block(params, spec, *args, causal=False, **kw),
              front[f"attn_{name}/{kind}"])


def test_cross_attention_checks_each_sides_positions():
    cfg = get_config(FRONT_ARCHS["whisper"])
    spec = transformer._cross_spec(cfg)
    p = transformer.init_params(cfg, device="cpu")["layers"][0]["cross"]
    x, kv = torch.zeros(1, 3, cfg.d_model), torch.zeros(1, 5, cfg.d_model)
    for bad in (torch.arange(3), torch.arange(1, 6)):
        with pytest.raises(ValueError, match="arange"):
            attention.kernel_attention(p, spec, x, torch.arange(3), kv_x=kv,
                                       kv_positions=bad, causal=False)
    with pytest.raises(ValueError, match="arange"):
        attention.attention_block(p, spec, x, torch.arange(1, 4), kv_x=kv,
                                  kv_positions=torch.arange(5), causal=False)


def test_encoder_is_not_causal():
    """The first frame's encoding depends on the later frames (redrawn
    at unit scale here: it moves by O(1), where a causal mask would leave
    it unchanged bit for bit)."""
    cfg = get_config(WHISPER + "-smoke")
    params = transformer.init_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    frames = frontends.audio_frames(cfg, 1, gen)
    later = frames.clone()
    later[:, 32:] = torch.randn(1, 32, cfg.d_model, generator=gen)
    a = transformer._encode(params, cfg, frames, kernel=True)
    b = transformer._encode(params, cfg, later, kernel=True)
    assert (a[:, 0] - b[:, 0]).abs().max() > 0.1


# ---------------------------------------------------------------------------
# the model and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", WHISPER_LAYERS)
def test_convert_unstacks_reference_layout(front, n_layers):
    cfg, flat = cfg_of(n_layers), sub(front, f"whisper{n_layers}/params")
    params = port_params(front, n_layers)
    assert len(params["layers"]) == n_layers
    assert len(params["enc_layers"]) == cfg.encoder_layers
    scanned = transformer.stack_plan(cfg)[2] > 1
    assert scanned == (n_layers == 4)
    for i, lay in enumerate(params["layers"]):
        want = (flat["layers_scan/0/cross/wk"][i] if scanned
                else flat[f"layers_head/{i}/cross/wk"])
        assert np.array_equal(lay["cross"]["wk"].numpy(), want)
    assert np.array_equal(params["enc_layers"][1]["attn"]["wq"].numpy(),
                          flat["enc_layers/1/attn/wq"])
    back = convert.lm_params_to_reference(params, cfg)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(ValueError, match="stray"):
        convert.lm_params_from_reference(
            {**flat, "enc_extra/w": flat["embed"]}, cfg, device="cpu")


@pytest.mark.parametrize("n_layers", WHISPER_LAYERS)
def test_forward_matches_reference(front, n_layers):
    p = f"whisper{n_layers}"
    logits = transformer.forward(
        port_params(front, n_layers), cfg_of(n_layers),
        {"tokens": t(front[f"{p}/forward_tokens"]).long(),
         "frames": frames_of(front, n_layers)})
    close(logits, front[f"{p}/forward_logits"])


@pytest.mark.parametrize("n_layers", WHISPER_LAYERS)
def test_prefill_and_decode_steps_match_reference(front, n_layers):
    cfg, p = cfg_of(n_layers), f"whisper{n_layers}"
    params = port_params(front, n_layers)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    fa.KERNEL.launches = 0
    last, cache = transformer.prefill(
        params, cfg, {"tokens": t(front[f"{p}/prompts"]).long(),
                      "frames": frames_of(front, n_layers)}, cache)
    assert fa.KERNEL.launches == 0          # the CPU runs the plain versions
    close(last, front[f"{p}/prefill_logits"])
    close(cache["enc_out"], front[f"{p}/prefill_cache/enc_out"])
    for i in range(n_layers):
        for leaf in ("k", "v"):
            close(cache["layers"][i]["kv"][leaf],
                  layer_kv(front, f"{p}/prefill_cache", cfg, i, leaf))
    steps = t(front[f"{p}/decode_tokens"]).long()
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, cfg, steps[:, i:i + 1], cache,
            torch.full((B,), PROMPT + i, dtype=torch.long))
        close(logits, front[f"{p}/decode_logits"][i])
    close(cache["enc_out"], front[f"{p}/decode_cache/enc_out"])
    for i in range(n_layers):
        for leaf in ("k", "v"):
            close(cache["layers"][i]["kv"][leaf],
                  layer_kv(front, f"{p}/decode_cache", cfg, i, leaf))


@pytest.mark.parametrize("n_layers", WHISPER_LAYERS)
def test_greedy_generate_equals_reference(front, n_layers):
    p = f"whisper{n_layers}"
    engine = ServeEngine(cfg_of(n_layers), port_params(front, n_layers),
                         max_len=MAX_LEN, device="cpu")
    out = engine.generate(front[f"{p}/prompts"], new_tokens=NEW,
                          extra_batch={"frames": front[f"{p}/frames"]})
    np.testing.assert_array_equal(out, front[f"{p}/generate_tokens"])


def test_decode_equals_own_forward():
    """Prefill, then decode steps feeding tokens back, against the plain
    forward over the prompt and the tokens: the learned positions of the
    fed-back tokens and the cross attention from a zero query position."""
    cfg = get_config(WHISPER + "-smoke")
    params = transformer.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    frames = frontends.audio_frames(cfg, 2, gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    fed = torch.randint(0, cfg.vocab_size, (2, 3), generator=gen)
    cache = transformer.init_cache(cfg, 2, 12, torch.float32, "cpu")
    _, cache = transformer.prefill(params, cfg, {"tokens": prompts,
                                                 "frames": frames}, cache)
    full = transformer.forward(params, cfg, {
        "tokens": torch.cat([prompts, fed], 1), "frames": frames})
    for i in range(3):
        logits, cache = transformer.decode_step(
            params, cfg, fed[:, i:i + 1], cache,
            torch.full((2,), 6 + i, dtype=torch.long))
        close(logits[:, 0], full[:, 6 + i].numpy())


def test_frames_are_required_and_lengths_checked_on_the_host():
    cfg = get_config(WHISPER + "-smoke")
    params = transformer.init_params(cfg, device="cpu")
    engine = ServeEngine(cfg, params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    frames = frontends.audio_frames(cfg, 1, gen)
    prompt = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="frames"):
        engine.generate(prompt, new_tokens=2)
    with pytest.raises(ValueError, match="frames"):
        transformer.forward(params, cfg, {"tokens": t(prompt)})
    # the last fed-back token would sit at position max_position
    with pytest.raises(ValueError, match="learned table"):
        engine.generate(np.zeros((1, cfg.max_position - 1), np.int64),
                        new_tokens=3, extra_batch={"frames": frames})
    long_frames = torch.zeros(1, cfg.encoder_seq + 1, cfg.d_model)
    with pytest.raises(ValueError, match="encoder's learned table"):
        engine.generate(prompt, new_tokens=2,
                        extra_batch={"frames": long_frames})
    with pytest.raises(ValueError, match="no batch inputs"):
        transformer.forward(params, cfg, {"tokens": t(prompt),
                                          "frames": frames,
                                          "patch_embeds": frames})
    # the longest prompt the table takes still serves
    out = engine.generate(np.zeros((1, cfg.max_position - 2), np.int64),
                          new_tokens=3, extra_batch={"frames": frames})
    assert out.shape == (1, 3)


def test_prefill_reads_nothing_back_from_the_device(monkeypatch):
    """Whisper's prefill (the encoder, self and cross attention) makes no
    call that copies a tensor to the host: ``Tensor.cpu``, ``.item`` and
    ``.tolist`` raise while it runs."""
    cfg = get_config(WHISPER + "-smoke")
    params = transformer.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                     generator=gen),
             "frames": frontends.audio_frames(cfg, 2, gen)}
    cache = transformer.init_cache(cfg, 2, 8, torch.float32, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a read back from the device")

    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    last, cache = transformer.prefill(params, cfg, batch, cache)
    monkeypatch.undo()
    assert last.shape == (2, cfg.vocab_size) and torch.isfinite(last).all()


def test_launcher_serves_whisper_smoke_on_cpu(capsys):
    launch_serve.main(["--arch", WHISPER + "-smoke", "--batch", "2",
                       "--prompt-len", "4", "--new-tokens", "4",
                       "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
