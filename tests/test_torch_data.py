"""The port's synthetic token pipeline (``repro_torch.data``) against the
reference's ``repro.data.synthetic``.

The reference draws from threefry, the port from a ``torch.Generator``, so
the tokens cannot be equal. What the tests hold: the shapes and dtypes of
the reference's batches (int32 (B, S) ``tokens`` and ``labels``, the same
array), the vocabulary range, determinism in (seed, step), and the chain's
statistics: x_t = perm[x_{t−1}] unless a uniform draw replaces it with
probability 0.15, so the share of chain successors is 0.85 + 0.15/V.
Over B·(S − 1) = 16320 transitions its binomial sd is 0.0028; the test
allows 5 sd. A vision model's batch also holds the frontend's stub
patches, which take ``num_patches`` of the sequence, and an
encoder-decoder's the stub frames, as the reference's
``data/synthetic.py:44-50``; ``train.loop.lm_step_inputs`` splits each
leaf into (N, per agent, ...). The stubs (``models.frontends``) are 0.02
times a standard normal: over n draws the sample sd lies within 5 of its
own sd (1/√(2n), relative) of 0.02 and the mean within 5 sd (0.02/√n)
of 0.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.data import batch_seed, make_batch, synthetic_batch_iterator
from repro_torch.data.synthetic import NOISE_P
from repro_torch.models import frontends
from repro_torch.train.loop import TrainConfig, lm_step_inputs

SMOKE = get_config("gemma3-4b-smoke")


def test_batch_shapes_dtypes_and_labels():
    gen = torch.Generator().manual_seed(0)
    b = make_batch(SMOKE, dict(global_batch=3, seq_len=17), gen)
    assert sorted(b) == ["labels", "tokens"]
    assert b["tokens"].shape == (3, 17) and b["tokens"].dtype == torch.int32
    assert b["labels"] is b["tokens"]
    assert int(b["tokens"].min()) >= 0
    assert int(b["tokens"].max()) < SMOKE.vocab_size


def test_batches_are_a_function_of_seed_and_step():
    shape = dict(global_batch=2, seq_len=32)
    a = synthetic_batch_iterator(SMOKE, shape, seed=4, device="cpu")
    b = synthetic_batch_iterator(SMOKE, shape, seed=4, device="cpu")
    c = synthetic_batch_iterator(SMOKE, shape, seed=5, device="cpu")
    first = [next(a)["tokens"] for _ in range(3)]
    assert all(torch.equal(x, next(b)["tokens"]) for x in first)
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0], next(c)["tokens"])
    again = make_batch(SMOKE, shape,
                       torch.Generator().manual_seed(batch_seed(4, 2)))
    assert torch.equal(again["tokens"], first[2])


def test_chain_statistics():
    b, s, v = 64, 256, SMOKE.vocab_size
    gen = torch.Generator().manual_seed(7)
    tokens = make_batch(SMOKE, dict(global_batch=b, seq_len=s),
                        gen)["tokens"].long()
    perm = torch.randperm(v, generator=torch.Generator().manual_seed(7))
    share = (tokens[:, 1:] == perm[tokens[:, :-1]]).double().mean().item()
    expect = (1 - NOISE_P) + NOISE_P / v
    sd = (expect * (1 - expect) / (b * (s - 1))) ** 0.5
    assert abs(share - expect) < 5 * sd, (share, expect, sd)
    # the noise tokens are uniform: every token of a 512 vocabulary occurs
    assert torch.unique(tokens).numel() > 0.9 * v


WHISPER = get_config("whisper-tiny-smoke")
LLAVA = get_config("llava-next-mistral-7b-smoke")


@pytest.mark.parametrize("name,fn,rows", [
    ("whisper-tiny", frontends.audio_frames, 1500),
    ("llava-next-mistral-7b", frontends.vision_patches, 2880)])
def test_frontend_stubs_shapes_and_scale(name, fn, rows):
    """The stubs at the full configs' widths: (B, rows, d_model) float32
    on the generator's device, 0.02·N(0, 1), a function of the
    generator's seed."""
    cfg = get_config(name)
    out = fn(cfg, 2, torch.Generator().manual_seed(0))
    assert out.shape == (2, rows, cfg.d_model)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    n = out.numel()
    assert abs(out.std().item() / 0.02 - 1) < 5 * (0.5 / n) ** 0.5
    assert abs(out.mean().item()) < 5 * 0.02 / n ** 0.5
    again = fn(cfg, 2, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(out, fn(cfg, 2,
                                   torch.Generator().manual_seed(1)))
    assert fn(cfg, 1, torch.Generator().manual_seed(0),
              dtype=torch.float64).dtype == torch.float64


def test_make_batch_frontend_leaves():
    """llava's tokens take seq_len − num_patches positions beside its
    patches; whisper's batch adds its encoder_seq frames. The tokens are
    drawn first: a generator seeded alike gives the text model's."""
    shape = dict(global_batch=3, seq_len=40)
    b = make_batch(LLAVA, shape, torch.Generator().manual_seed(0))
    assert sorted(b) == ["labels", "patch_embeds", "tokens"]
    assert b["tokens"].shape == (3, 40 - LLAVA.num_patches)
    assert b["patch_embeds"].shape == (3, LLAVA.num_patches, LLAVA.d_model)
    w = make_batch(WHISPER, shape, torch.Generator().manual_seed(0))
    assert sorted(w) == ["frames", "labels", "tokens"]
    assert w["tokens"].shape == (3, 40) and w["labels"] is w["tokens"]
    assert w["frames"].shape == (3, WHISPER.encoder_seq, WHISPER.d_model)
    text = make_batch(dataclasses.replace(WHISPER, frontend=None,
                                          encoder_layers=0), shape,
                      torch.Generator().manual_seed(0))
    assert torch.equal(text["tokens"], w["tokens"])
    with pytest.raises(ValueError, match="no token"):
        make_batch(LLAVA, dict(global_batch=1, seq_len=LLAVA.num_patches),
                   torch.Generator().manual_seed(0))


@pytest.mark.parametrize("cfg", [WHISPER, LLAVA, SMOKE],
                         ids=["whisper", "llava", "text"])
def test_lm_step_inputs_split_every_leaf_by_agent(cfg):
    tc = TrainConfig(n_agents=4, iters=1, netes=NetESConfig())
    batch, _ = lm_step_inputs(cfg, tc, 0, seq_len=48, per_agent_batch=2,
                              device="cpu")
    s_text = 48 - cfg.num_patches if cfg.frontend == "vision" else 48
    assert batch["tokens"].shape == (4, 2, s_text)
    assert batch["labels"].shape == (4, 2, s_text)
    if cfg.frontend == "vision":
        assert batch["patch_embeds"].shape == (4, 2, cfg.num_patches,
                                               cfg.d_model)
    if cfg.is_encoder_decoder:
        assert batch["frames"].shape == (4, 2, cfg.encoder_seq, cfg.d_model)
    flat = make_batch(cfg, dict(global_batch=8, seq_len=48),
                      torch.Generator().manual_seed(0))
    assert sorted(flat) == sorted(batch)
