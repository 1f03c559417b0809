"""Sharding context: the port of ``repro.distributed.context``. Model code
asks for an activation's layout by role, without a mesh threaded through
every layer.

Model code calls ``maybe_constrain(x, role)``. Outside a
``sharding_context`` it returns ``x`` itself. Inside one, a role that the
context names resolves to a partition spec (``distributed.sharding.P``),
and a ``torch.distributed.tensor.DTensor`` is redistributed to that
spec's placements over the context's ``DeviceMesh``; a plain tensor, which
has no layout to change, comes back unchanged. The reference's
``with_sharding_constraint`` is a hint to the compiler; a DTensor's
redistribution moves the data then and there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from .sharding import P, to_placements

_STATE = threading.local()


def current() -> Optional[Dict]:
    """The active context, ``{"mesh": ..., "roles": ...}``, or None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_context(mesh, roles: Dict[str, P]):
    """``roles``: role name → spec, e.g. ``{"residual": P(None, "model",
    None)}`` (the leading dims those of the tensors the model passes);
    ``mesh``: the ``DeviceMesh`` whose dims the specs name."""
    prev = current()
    _STATE.ctx = {"mesh": mesh, "roles": roles}
    try:
        yield
    finally:
        _STATE.ctx = prev


def maybe_constrain(x: torch.Tensor, role: str) -> torch.Tensor:
    ctx = current()
    if ctx is None or role not in ctx["roles"]:
        return x
    spec = ctx["roles"][role]
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    # unmentioned trailing dims are replicated
    parts = tuple(spec) + (None,) * (x.ndim - len(spec))
    return x.redistribute(ctx["mesh"], to_placements(P(*parts), ctx["mesh"]))
