"""Meshes: the process group of a sharded run (``--shards n``), the
port's counterpart of ``make_host_mesh`` (``repro.launch.mesh``), and the
reference's production mesh as a named shape (``make_production_mesh``).

A torch process group runs one process a rank, so a sharded run is
started by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` for each process:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train rl --shards 4

A world of one needs no launcher: without ``torchrun`` and with n = 1 the
group is made here from a file store. The backend is NCCL, each rank on
``cuda:LOCAL_RANK``; ``device="cpu"`` asks for gloo on the CPU. Nothing
falls back from one to the other.

Both kinds name their axes: ``axis_names`` and a ``shape`` mapping from
each name to its size, as a ``jax.sharding.Mesh`` does, so that the
sharding rules (``distributed.sharding``) take either. A process group is
the 1-D agent axis: ``("data", "model")`` of sizes (world size, 1).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D mesh over the agent axis: the process
    group, this process's rank, the world size and the rank's device.
    ``owns_group`` is set when :func:`make_host_mesh` made the group (and
    :meth:`close` tears it down)."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    owns_group: bool = False
    _store_path: Optional[str] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world_size, "model": 1}

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Destroy the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False
        if self._store_path is not None and os.path.exists(self._store_path):
            os.unlink(self._store_path)
        self._store_path = None


@dataclasses.dataclass(frozen=True)
class NamedShape:
    """A mesh's named shape alone, with no devices: what the sharding
    rules and ``launch.specs.classify`` read of a mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes, strict=True))


def make_production_mesh(*, multi_pod: bool = False) -> NamedShape:
    """The reference's production mesh (``repro.launch.mesh``) as a named
    shape: 16 × 16 ``("data", "model")``, or 2 × 16 × 16 ``("pod",
    "data", "model")`` with ``multi_pod``. It holds no devices: placement
    modes and partition specs are computed for it, nothing runs on it."""
    if multi_pod:
        return NamedShape(("pod", "data", "model"), (2, 16, 16))
    return NamedShape(("data", "model"), (16, 16))


def torchrun_command(n: int) -> str:
    return ("torchrun --nproc-per-node {n} -m repro_torch.launch.train rl "
            "--shards {n} ...").format(n=n)


def make_host_mesh(num_shards: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda") -> Mesh:
    """The mesh of ``num_shards`` ranks (the launcher's world size if
    None). Under ``torchrun`` the world size must equal ``num_shards``; a
    group already made in this process is reused. Without ``torchrun``
    only a world of one can be made; a larger one raises with the
    ``torchrun`` command line."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    backend = "nccl" if kind == "cuda" else "gloo"
    launched = "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    n = world if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards={n}")
    if launched and world != n:
        raise ValueError(f"--shards {n} under a launcher of WORLD_SIZE="
                         f"{world}: start {n} processes, e.g. "
                         + torchrun_command(n))
    if not launched and n > 1:
        raise RuntimeError(f"--shards {n} needs one process a rank; start "
                           "it with " + torchrun_command(n))
    rank = int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", 0))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device, and none is "
                               "visible; pass device='cpu' for gloo")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        if dist.get_world_size() != n or dist.get_backend() != backend:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks on "
                f"{dist.get_backend()} exists; this mesh needs {n} on "
                f"{backend}")
        return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    world_size=n, device=dev)
    store_path = None
    if launched:
        dist.init_process_group(backend, init_method="env://",
                                world_size=n, rank=rank)
    else:
        fd, store_path = tempfile.mkstemp(prefix="repro_torch_mesh_")
        os.close(fd)
        os.unlink(store_path)
        dist.init_process_group(backend, store=dist.FileStore(store_path, 1),
                                world_size=1, rank=0)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world_size=n,
                device=dev, owns_group=True, _store_path=store_path)
