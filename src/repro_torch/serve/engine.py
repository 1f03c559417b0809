"""Batched serving engine: the port of ``repro/serve/engine.py``. One
full-sequence prefill (attention through the flash kernel, an
encoder-decoder's encoder and cross attention too; an MoE layer's router,
a mamba layer's scan and an rwkv layer's WKV recurrence through theirs),
then a token loop of ``decode_step``.

With ``trace`` the engine writes serve telemetry into the JSONL trace
layer (``obs.trace``, DESIGN.md §15): a ``prefill`` span and a ``decode``
span per ``generate``, and ``prefill.rate``/``decode.rate`` events.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..models import transformer
from ..obs import Trace, device_get


class ServeEngine:
    """Serves ``cfg`` with the parameters ``params`` (from
    ``transformer.init_params`` or ``convert.lm_params_from_reference``),
    which must already lie on ``device`` in ``dtype``.

    ``trace`` (a path or an open ``obs.Trace``) turns on serve-side
    latency telemetry: one ``prefill`` span (``batch``,
    ``prompt_tokens``) and one ``decode`` span (``batch``, ``new_tokens``)
    per ``generate``, each stamped with the kernel builds and host
    transfers inside it, and the events ``prefill.rate`` and
    ``decode.rate`` (``tokens``, ``tok_per_s``). The engine owns the trace
    only when it opened it (a path); ``close()`` closes that one.

    Tracing adds no host sync: the spans are host-clock intervals (the
    prefill span covers its launches; the decode span ends with the tokens
    on the host, so it also covers the device work still queued), and the
    rates come from CUDA events read after the tokens reach the host (on
    the CPU, from the host clock)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda", trace=None):
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
        self._owns_trace = not isinstance(trace, Trace)
        self._trace = (trace if isinstance(trace, Trace) else
                       Trace(trace, name=f"serve:{cfg.name}",
                             device=self.device))

    def close(self) -> None:
        """Close the engine's trace (a no-op for an untraced engine and for
        a trace the caller owns)."""
        if self._owns_trace:
            self._trace.close()

    def _mark(self):
        """A point on the device's timeline: a recorded CUDA event, or on
        the CPU the host clock (the CPU runs each op as it is called)."""
        if not self._trace.active:
            return None
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _seconds(self, a, b) -> float:
        """Seconds between two marks whose work has completed."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

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

        ``extra_batch`` holds the frontends' inputs. An encoder-decoder
        (whisper) needs ``frames`` (B, T, D): the encoder runs once in the
        prefill, and every step attends its output. A vision model's
        ``patch_embeds`` are dropped, as the reference drops them: its
        ``decode_step`` embeds tokens only, so its serving never attends
        the patches, and the prompt's positions start at 0.
        """
        extra = dict(extra_batch or {})
        extra.pop("patch_embeds", None)
        if self.cfg.is_encoder_decoder and extra.get("frames") is None:
            raise ValueError("encoder-decoder serving needs 'frames'")
        extra = {k: torch.as_tensor(v, device=self.device, dtype=self.dtype)
                 for k, v in extra.items()}
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s_prompt = prompts.shape
        frames = extra.get("frames")
        # the last step feeds position s_prompt + new_tokens − 2 back
        transformer.check_lengths(self.cfg, s_prompt + new_tokens - 1,
                                  None if frames is None else
                                  frames.shape[1])
        cache = transformer.init_cache(
            self.cfg, b, max(self.max_len, s_prompt + new_tokens),
            self.dtype, self.device)
        sample = temperature > 0 and generator is not None

        def pick(logits):                               # (B, V) → (B, 1)
            if sample:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=generator)
            return torch.argmax(logits, dim=-1, keepdim=True)

        tr = self._trace
        with torch.no_grad():
            m0 = self._mark()
            with tr.span("prefill", batch=b, prompt_tokens=b * s_prompt):
                last_logits, cache = transformer.prefill(
                    self.params, self.cfg, {"tokens": prompts, **extra},
                    cache)
                token = pick(last_logits)
            m1 = self._mark()
            out = [token]
            with tr.span("decode", batch=b, new_tokens=new_tokens):
                for i in range(1, new_tokens):
                    pos = torch.full((b,), s_prompt + i - 1,
                                     dtype=torch.long, device=self.device)
                    logits, cache = transformer.decode_step(
                        self.params, self.cfg, token, cache, pos)
                    token = pick(logits[:, 0])
                    out.append(token)
                m2 = self._mark()
                tokens = device_get(torch.cat(out, dim=1).to(torch.int32))
        if tr.active:
            for name, n, a, z in (("prefill.rate", b * s_prompt, m0, m1),
                                  ("decode.rate", b * new_tokens, m1, m2)):
                dt = max(self._seconds(a, z), 1e-9)
                tr.event(name, tokens=n, tok_per_s=n / dt, device_s=dt)
        return tokens.numpy()
