"""The paper's policy network: an MLP with two 64-unit tanh hidden layers
(§5.2, matching Salimans et al.) on a flat parameter vector, applied to M
parameter vectors at once.

The flat layout follows ``layer_shapes`` exactly as the reference does: for
each layer, W row-major (din, dout), then b (dout,). Anything else would
give the same vector another meaning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MLPPolicy:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (64, 64)
    discrete: bool = False

    @property
    def layer_shapes(self):
        dims = (self.obs_dim,) + self.hidden + (self.act_dim,)
        shapes = []
        for din, dout in zip(dims[:-1], dims[1:], strict=True):
            shapes.append((din, dout))
            shapes.append((dout,))
        return shapes

    @property
    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.layer_shapes)

    def init(self, generator: torch.Generator, count: int) -> torch.Tensor:
        """``count`` Glorot-ish parameter vectors (count, D): weights
        N(0, 2/(din+dout)), biases zero."""
        dev = generator.device
        parts = []
        for shape in self.layer_shapes:
            if len(shape) == 2:
                scale = math.sqrt(2.0 / (shape[0] + shape[1]))
                parts.append(scale * torch.randn(
                    count, math.prod(shape), generator=generator,
                    device=dev))
            else:
                parts.append(torch.zeros(count, shape[0], device=dev))
        return torch.cat(parts, dim=1)

    def unflatten(self, thetas: torch.Tensor) -> List[torch.Tensor]:
        """(M, D) → per-layer tensors (M, din, dout) and (M, dout)."""
        m = thetas.shape[0]
        params, offset = [], 0
        for shape in self.layer_shapes:
            size = math.prod(shape)
            params.append(
                thetas[:, offset:offset + size].reshape((m,) + shape))
            offset += size
        return params

    def apply_unflat(self, params: List[torch.Tensor],
                     obs: torch.Tensor) -> torch.Tensor:
        """Actions (M, act_dim) for observations (M, obs_dim)."""
        h = obs
        n_layers = len(params) // 2
        for i in range(n_layers):
            w, b = params[2 * i], params[2 * i + 1]
            h = torch.baddbmm(b.unsqueeze(1), h.unsqueeze(1), w).squeeze(1)
            if i < n_layers - 1:
                h = torch.tanh(h)
        if self.discrete:
            return h  # logits; env takes argmax
        return torch.tanh(h)  # bounded continuous action

    def apply(self, thetas: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """Row m of ``thetas (M, D)`` acts on row m of ``obs (M, obs_dim)``."""
        return self.apply_unflat(self.unflatten(thetas), obs)
