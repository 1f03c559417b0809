"""Plain SGD with momentum: the port of ``repro/optim/sgd.py``
(OpenAI-ES applies its estimate with Adam or SGD; kept for ablations)."""
from __future__ import annotations

from typing import Any, Optional

from ..core.tree import tree_map


def sgd_update(params: Any, grads: Any, momentum: Optional[Any] = None, *,
               lr: float = 1e-2, beta: float = 0.9):
    """m' = β·m + g, p' = p − lr·m' (m = 0 when ``momentum`` is None).
    Returns (new params, new momentum)."""
    if momentum is None:
        momentum = tree_map(lambda g: g * 0.0, grads)
    new_m = tree_map(lambda m, g: beta * m + g, momentum, grads)
    new_p = tree_map(lambda p, m: p - lr * m, params, new_m)
    return new_p, new_m
