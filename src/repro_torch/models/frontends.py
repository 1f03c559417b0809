"""Modality frontend stubs: the port of ``repro/models/frontends.py``.

As in the reference, the mel-spectrogram and conv codec (whisper) and the
vision tower and projector (llava) are not implemented: these providers
give precomputed frame or patch embeddings of the right shape, 0.02 times
a standard normal, where a deployment would plug the real towers in. Each
draws from an explicit ``torch.Generator`` on that generator's device.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def _stub(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return out.normal_(generator=generator).mul_(0.02).to(dtype)


def audio_frames(cfg: ModelConfig, batch: int, generator: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """The whisper encoder's stub input: (B, encoder_seq, d_model)."""
    return _stub(generator, (batch, cfg.encoder_seq, cfg.d_model), dtype)


def vision_patches(cfg: ModelConfig, batch: int, generator: torch.Generator,
                   dtype=torch.float32) -> torch.Tensor:
    """llava's stub anyres patch embeddings: (B, num_patches, d_model)."""
    return _stub(generator, (batch, cfg.num_patches, cfg.d_model), dtype)
