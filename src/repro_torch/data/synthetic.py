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
statistics are. A vision model's batch also holds the frontend's stub
``patch_embeds`` and its tokens fill the rest of the sequence; an
encoder-decoder's holds stub ``frames`` (``models.frontends``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Union

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..core.es_utils import stream_seed
from ..models import frontends

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
    ``shape["seq_len"]`` positions, drawn from ``generator`` on its
    device: ``tokens`` and ``labels`` (the same tensor; the loss shifts
    it). For a vision model ``num_patches`` of the positions are the
    stub ``patch_embeds`` (B, P, D) and the tokens the other
    ``seq_len − num_patches``; an encoder-decoder's batch adds stub
    ``frames`` (B, encoder_seq, D). The tokens are drawn first."""
    b, s = shape["global_batch"], shape["seq_len"]
    s_text = s - cfg.num_patches if cfg.frontend == "vision" else s
    if s_text < 1:
        raise ValueError(f"{cfg.name}: seq_len {s} leaves no token after "
                         f"its {cfg.num_patches} patches")
    tokens = _markov_tokens(generator, b, s_text, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = frontends.vision_patches(cfg, b, generator)
    elif cfg.frontend == "audio":
        batch["frames"] = frontends.audio_frames(cfg, b, generator)
    return batch


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
