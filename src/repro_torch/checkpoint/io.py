"""Checkpointing: flat-key npz of the port's state trees.

The port of ``repro.checkpoint.io``. A tree is nested dicts, lists, tuples
and dataclasses (``NetESState``, ``ChannelState``, ``ScheduleState``,
``MetricsState``, ``Topology``); its leaves are tensors, host ints (an int64 array) and
``torch.Generator``s (their ``get_state()``, a uint8 array); None holds no
leaf. Each leaf is stored under its path, keyed as the reference's
``_path_key`` keys it: the parts joined by ``::``, each part with ``\\``
and ``:`` escaped; a dict key or a list index is the part itself, a
dataclass field is ``.<name>``, and a ``Topology``'s payloads are numbered
as the reference's pytree numbers its children (0 ``deg``, 1 ``adj``, 2
``neighbor_idx``, 3 ``neighbor_mask``, 4 a scheduled circulant's
``shifts``, an int32 array). So the reference's NetES state is at
``netes::.thetas``, a schedule's topology at ``sched::.topo::0`` and a
probe ring at ``obs::.buf`` and ``obs::.cursor`` in both packages' files.

``load_pytree`` restores into the structure of a tree ``like``: each leaf's
shape and dtype must match (a silent cast could corrupt state), a missing
leaf raises, and each tensor and generator goes to the device of its
counterpart in ``like``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.topology_repr import Topology

_SEP = "::"
# a Topology's payloads in the order of the reference's pytree children
_TOPOLOGY_CHILDREN = ("deg", "adj", "neighbor_idx", "neighbor_mask", "shifts")

PathLike = Union[str, pathlib.Path]


def _escape(part: str) -> str:
    """Escape ':' (and the escape char itself) so no single path part can
    contain the ``::`` separator."""
    return part.replace("\\", "\\\\").replace(":", "\\:")


def path_key(path: Sequence[str]) -> str:
    """The flat key of a leaf at ``path`` (its parts, outermost first)."""
    return _SEP.join(_escape(part) for part in path)


def _map(fn: Callable, node: Any, path: Tuple[str, ...] = ()) -> Any:
    """``node`` with each leaf replaced by ``fn(path, leaf)``."""
    if node is None:
        return None
    if isinstance(node, (torch.Tensor, torch.Generator)) or type(node) is int:
        return fn(path, node)
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(node))
    if isinstance(node, Topology):
        kw = {}
        for i, name in enumerate(_TOPOLOGY_CHILDREN):
            v = getattr(node, name)
            if name == "shifts" and v is not None:
                v = fn(path + (str(i),), torch.tensor(v, dtype=torch.int32))
                kw[name] = tuple(int(d) for d in v.tolist())
            else:
                kw[name] = _map(fn, v, path + (str(i),))
        return dataclasses.replace(node, **kw)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _map(fn, getattr(node, f.name), path + ("." + f.name,))
            for f in dataclasses.fields(node) if f.init})
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                    f"{path_key(path)!r}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int64)


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], np.dtype]:
    """The shape and numpy dtype a leaf is stored with."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty((), dtype=leaf.dtype).numpy().dtype)
    arr = _to_numpy(leaf)
    return arr.shape, arr.dtype


def save_pytree(path: PathLike, tree: Any) -> None:
    arrays: Dict[str, np.ndarray] = {}

    def put(p, leaf):
        arrays[path_key(p)] = _to_numpy(leaf)
        return leaf

    _map(put, tree)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_pytree(path: PathLike, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape and dtype checked)."""
    with np.load(path, allow_pickle=False) as data:
        def get(p, ref):
            key = path_key(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            shape, dtype = _shape_dtype(ref)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {shape}")
            if arr.dtype != dtype:
                raise ValueError(f"dtype mismatch for {key}: "
                                 f"{arr.dtype} vs {dtype}")
            if isinstance(ref, torch.Generator):
                gen = torch.Generator(device=ref.device)
                gen.set_state(torch.from_numpy(arr.copy()))
                return gen
            if isinstance(ref, torch.Tensor):
                return torch.from_numpy(arr.copy()).to(ref.device)
            return int(arr)

        return _map(get, like)


def save_train_state(directory: PathLike, step: int, tree: Any,
                     extra: Optional[Dict] = None, *,
                     mesh=None) -> pathlib.Path:
    """``step_<step>.npz`` and ``.json``, then ``latest.json`` pointing at
    them, written to a temporary file and renamed over the old pointer:
    a crash while writing leaves the previous pointer whole.

    With ``mesh`` (a ``launch.mesh.Mesh``: a sharded run, whose ranks each
    hold the whole gathered state) rank 0 writes and every rank waits for
    it, so the file is the same for any shard count and restores at any
    other (the reference's ``device_get``)."""
    directory = pathlib.Path(directory)
    ckpt = directory / f"step_{step:08d}.npz"
    if mesh is None or mesh.rank == 0:
        directory.mkdir(parents=True, exist_ok=True)
        save_pytree(ckpt, tree)
        meta = {"step": step, **(extra or {})}
        (directory / f"step_{step:08d}.json").write_text(json.dumps(meta))
        tmp = directory / "latest.json.tmp"
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, directory / "latest.json")
    if mesh is not None:
        mesh.barrier()
    return ckpt


def restore_train_state(directory: PathLike, like: Any) -> Tuple[int, Any]:
    """(step, tree) of the checkpoint ``latest.json`` points at."""
    directory = pathlib.Path(directory)
    meta = json.loads((directory / "latest.json").read_text())
    step = meta["step"]
    return step, load_pytree(directory / f"step_{step:08d}.npz", like)
