"""The port's synthetic token pipeline (``repro_torch.data``) against the
reference's ``repro.data.synthetic``.

The reference draws from threefry, the port from a ``torch.Generator``, so
the tokens cannot be equal. What the tests hold: the shapes and dtypes of
the reference's batches (int32 (B, S) ``tokens`` and ``labels``, the same
array), the vocabulary range, determinism in (seed, step), and the chain's
statistics: x_t = perm[x_{t−1}] unless a uniform draw replaces it with
probability 0.15, so the share of chain successors is 0.85 + 0.15/V.
Over B·(S − 1) = 16320 transitions its binomial sd is 0.0028; the test
allows 5 sd. The reference's vision and audio inputs raise, naming slice
6f.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import batch_seed, make_batch, synthetic_batch_iterator
from repro_torch.data.synthetic import NOISE_P

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


@pytest.mark.parametrize("frontend", ["vision", "audio"])
def test_frontends_raise_naming_their_slice(frontend):
    cfg = dataclasses.replace(SMOKE, frontend=frontend)
    with pytest.raises(NotImplementedError, match="slice 6f"):
        make_batch(cfg, dict(global_batch=1, seq_len=8),
                   torch.Generator().manual_seed(0))
