"""Batched serving engine: the port of ``repro/serve/engine.py``. One
full-sequence prefill (attention through the flash kernel; an MoE
layer's router, a mamba layer's scan and an rwkv layer's WKV recurrence
through theirs), then a token loop of ``decode_step``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..models import transformer


class ServeEngine:
    """Serves ``cfg`` with the parameters ``params`` (from
    ``transformer.init_params`` or ``convert.lm_params_from_reference``),
    which must already lie on ``device`` in ``dtype``. ``trace`` (the
    reference's serve telemetry) comes with slice 4 and raises until then."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda", trace=None):
        if trace is not None:
            raise NotImplementedError(
                "ServeEngine trace= comes with slice 4 (telemetry)")
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type or embed.dtype != dtype:
            raise ValueError(
                f"params lie on {embed.device} in {embed.dtype}; the engine "
                f"serves on {self.device} in {dtype}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.dtype = dtype

    def generate(self, prompts, new_tokens: int = 16,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 extra_batch: Optional[Dict] = None) -> np.ndarray:
        """prompts: (B, S_prompt) integer tokens (a tensor or an array) →
        (B, new_tokens) int32.

        The prompt runs as ONE full-sequence ``transformer.prefill`` that
        writes the decode cache directly; decode then proceeds token by
        token. Greedy unless ``temperature > 0`` and a ``generator`` is
        given, in which case each token is sampled from
        softmax(logits / temperature) with that generator.
        """
        if extra_batch:
            raise NotImplementedError(
                f"batch inputs {sorted(extra_batch)} come with slice 6f "
                "(the vision and audio frontends)")
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s_prompt = prompts.shape
        cache = transformer.init_cache(
            self.cfg, b, max(self.max_len, s_prompt + new_tokens),
            self.dtype, self.device)
        sample = temperature > 0 and generator is not None

        def pick(logits):                               # (B, V) → (B, 1)
            if sample:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=generator)
            return torch.argmax(logits, dim=-1, keepdim=True)

        with torch.no_grad():
            last_logits, cache = transformer.prefill(
                self.params, self.cfg, {"tokens": prompts}, cache)
            token = pick(last_logits)
            out = [token]
            for i in range(1, new_tokens):
                pos = torch.full((b,), s_prompt + i - 1, dtype=torch.long,
                                 device=self.device)
                logits, cache = transformer.decode_step(
                    self.params, self.cfg, token, cache, pos)
                token = pick(logits[:, 0])
                out.append(token)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
