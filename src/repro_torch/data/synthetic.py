"""Deterministic synthetic token pipeline: the port of
``repro.data.synthetic``.

No real corpus: a *learnable* synthetic language, a first-order Markov
chain over the vocabulary (x_t = perm[x_{t−1}], replaced by a uniform
token with probability 0.15), so that a training loss can move. A batch is
a pure function of its generator's seed, and ``synthetic_batch_iterator``
seeds step t's generator from (seed, t): any process can regenerate any
batch without communication.

The draws come from a ``torch.Generator``, not from threefry, so the
tokens are not the reference's; the shapes, dtypes, labels and the chain's
statistics are. The reference's vision and audio inputs come with slice 6f
(``models.transformer.check_ported`` names it).
"""
from __future__ import annotations

from typing import Dict, Iterator, Union

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..core.es_utils import stream_seed
from ..models.transformer import check_ported

NOISE_P = 0.15         # share of uniform (non-chain) successors


def _markov_tokens(gen: torch.Generator, batch: int, seq: int,
                   vocab: int) -> torch.Tensor:
    """(B, S) int32 tokens on the generator's device: x_t = perm[x_{t−1}]
    unless the step's noise draw replaces it by a uniform token."""
    dev = gen.device
    perm = torch.randperm(vocab, generator=gen, device=dev)
    x = torch.randint(0, vocab, (batch,), generator=gen, device=dev)
    noise = torch.rand((batch, seq), generator=gen, device=dev) < NOISE_P
    rand = torch.randint(0, vocab, (batch, seq), generator=gen, device=dev)
    toks = torch.empty((batch, seq), dtype=torch.int64, device=dev)
    for t in range(seq):
        x = torch.where(noise[:, t], rand[:, t], perm[x])
        toks[:, t] = x
    return toks.to(torch.int32)


def make_batch(cfg: ModelConfig, shape: Dict[str, int],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One global batch of ``shape["global_batch"]`` sequences of
    ``shape["seq_len"]`` tokens, drawn from ``generator`` on its device:
    ``tokens`` and ``labels`` (the same tensor; the loss shifts it)."""
    check_ported(cfg)
    tokens = _markov_tokens(generator, shape["global_batch"],
                            shape["seq_len"], cfg.vocab_size)
    return {"tokens": tokens, "labels": tokens}


def batch_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s batch generator."""
    return stream_seed(seed, step)


def synthetic_batch_iterator(cfg: ModelConfig, shape: Dict[str, int],
                             seed: int = 0,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches for steps 0, 1, ...: step t's from a generator on
    ``device`` seeded with ``batch_seed(seed, t)``."""
    dev = resolve_device(device)
    step = 0
    while True:
        gen = torch.Generator(device=dev).manual_seed(batch_seed(seed, step))
        yield make_batch(cfg, shape, gen)
        step += 1
