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
    # unmentioned trailing dims are replicated; a DTensor on a sub-mesh
    # (one replica-mode agent over "model") takes the spec over its dims
    parts = tuple(spec) + (None,) * (x.ndim - len(spec))
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(P(*parts), mesh))


def _dtensor_mesh(args):
    from torch.distributed.tensor import DTensor
    for a in args:
        if isinstance(a, DTensor):
            return a.device_mesh
    return None


def on_shards(fn, args, dims, out_dims):
    """``fn(*args)``, each device computing its own share when an
    argument is a DTensor (``local_map``). ``dims[i]`` says how
    ``args[i]`` is split: an int, the tensor dim split over the data axes
    (every mesh dim but ``"model"``); a pair (data dim, model dim), the
    second split over ``"model"`` too (it may be the same dim: then over
    all the axes); None, replicated (as every non-tensor argument is).
    ``out_dims`` says the same of the result, or is a list, one entry a
    result. Where the axes do not divide a split dim, that axis splits
    nothing (every device along it computes the whole call). DTensor
    redistributes each argument to its layout first, and the collectives
    that takes are counted by an ``op_costs`` recorder like any other. On
    plain tensors this is ``fn(*args)``."""
    mesh = _dtensor_mesh(args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .sharding import MODEL_AXIS

    names = tuple(mesh.mesh_dim_names)
    data = model = 1
    for i, name in enumerate(names):
        if name == MODEL_AXIS:
            model *= mesh.size(i)
        else:
            data *= mesh.size(i)

    def pair(entry):
        if entry is None:
            return None, None
        return (entry, None) if isinstance(entry, int) else tuple(entry)

    def fits(size_d, size_m):
        ok = True
        for a, e in zip(args, dims, strict=True):
            dd, md = pair(e)
            if not isinstance(a, torch.Tensor):
                continue
            if dd is not None and dd == md:
                ok &= a.shape[dd] % (size_d * size_m) == 0
            else:
                ok &= dd is None or a.shape[dd] % size_d == 0
                ok &= md is None or a.shape[md] % size_m == 0
        return ok

    use_data = fits(data, 1)
    use_model = fits(data if use_data else 1, model)

    def layout(entry):
        dd, md = pair(entry)
        return tuple(
            (Shard(md) if use_model and md is not None else Replicate())
            if name == MODEL_AXIS else
            (Shard(dd) if use_data and dd is not None else Replicate())
            for name in names)

    args = tuple(_replicated(a, mesh) for a in args)
    in_pl = tuple(layout(d) if isinstance(a, torch.Tensor) else None
                  for a, d in zip(args, dims, strict=True))
    outs = out_dims if isinstance(out_dims, list) else [out_dims]
    return local_map(fn, out_placements=tuple(layout(d) for d in outs),
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _replicated(t, mesh):
    """A plain tensor beside DTensors as the replicated DTensor it is
    (every rank made the same one)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def write_slots(buf: torch.Tensor, slot: torch.Tensor,
                vals: torch.Tensor) -> None:
    """``buf[b, slot[b]] = vals[b]`` for every row b, in place: buf (B, L,
    ...), slot (B,), vals (B, ...). On a DTensor each device writes the
    entries that fall in its own block of ``buf`` (rows and slots as its
    placements split them); ``slot`` and ``vals``, one entry a row, are
    gathered to every device first."""
    from torch.distributed.tensor import DTensor
    if not isinstance(buf, DTensor):
        buf[torch.arange(buf.shape[0], device=buf.device), slot] = vals
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():       # shape arithmetic, no tensor data
        shape, offset = compute_local_shape_and_global_offset(
            buf.shape, buf.device_mesh, buf.placements)
    slot, vals = (t.full_tensor() if isinstance(t, DTensor) else t
                  for t in (slot, vals))
    local = buf.to_local()
    r0, n_rows, c0, n_cols = offset[0], shape[0], offset[1], shape[1]
    slot, vals = slot[r0:r0 + n_rows] - c0, vals[r0:r0 + n_rows]
    inside = (slot >= 0) & (slot < n_cols)
    col = slot.clamp(0, max(n_cols - 1, 0))
    rows = torch.arange(n_rows, device=local.device)
    keep = local[rows, col]
    mask = inside.reshape((-1,) + (1,) * (vals.dim() - 1))
    local[rows, col] = torch.where(mask, vals.to(local.dtype), keep)
