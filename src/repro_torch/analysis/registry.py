"""Entry-point registry for the op contract layer: the port of
``repro.analysis.registry``.

This module is import-leaf (stdlib only at import time): hooked modules
import ``EntryPoint`` from here without creating a cycle, and
``iter_entry_points`` and the toy builders (``toy_state``,
``toy_topology``, ``place``) import the port lazily.

Registering a new entry point
-----------------------------
Define ``analysis_entry_points()`` in the module that owns the step and
add the module path to ``HOOKED_MODULES``::

    def analysis_entry_points():
        from repro_torch.analysis.registry import EntryPoint

        def build(device):
            ...  # construct fn + SMALL operands on ``device``
            return fn, args, kwargs

        return (EntryPoint(name="mymod.my_step", build=build),)

``build(device)`` must be cheap. The contract layer calls it under a
``FakeTensorMode`` with the card's device (fake CUDA tensors, or meta ones
on a build of PyTorch without CUDA: off the host, a copy to the host is
an op of its own) and runs the entry point once under
an ``op_costs.OpCosts`` recorder; ``chip_smoke.py`` builds the same entry
points on the card and runs them for real. ``generator(device)`` gives a
build its draws' generator. ``min_devices`` gates the entry points whose
structure exists only on a process group (halo rounds, rotating permute
chains): the contract layer runs those once per rank of a fake group of
that many ranks.

Contracts (see ``contracts.py``):

* ``no-host-sync``           — no scalar read, copy to the host or op of
  data-dependent shape in the recorded ops
* ``stable-carry``           — the state the entry point returns (``carry``)
  has the dtypes, shapes and devices of the state it took (a CUDA graph
  replay needs it); ``carry_exempt`` names fields exempt, with reasons
* ``rank-collective-parity`` — every rank issues the same ordered
  collectives (deadlock freedom)
* ``fused-seam-product``     — no fused multiply-add on a registered seam
  leaf (apply only to seam leaf functions)
* ``min_products``           — ratchet: the seam keeps at least this many
  separately rounded rank ≥ 2 products
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Tuple

DEFAULT_CONTRACTS: Tuple[str, ...] = (
    "no-host-sync", "stable-carry", "rank-collective-parity")

HOOKED_MODULES: Tuple[str, ...] = (
    "repro_torch.core.netes",
    "repro_torch.distributed.netes_dist",
    "repro_torch.distributed.fleet_shard",
    "repro_torch.distributed.permute_mixing",
    "repro_torch.kernels.netes_fused_mixing",
    "repro_torch.obs.probes",
)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str                                   # "module.entry" display id
    build: Callable[..., tuple]         # (device) -> (fn, args, kwargs)
    contracts: Tuple[str, ...] = DEFAULT_CONTRACTS
    min_products: int = 0                       # 0 = no product ratchet
    min_devices: int = 1                        # ranks of its process group
    # the state ``stable-carry`` compares: (name, index in the args, index
    # in the result) of each state the entry point takes and returns
    carry: Tuple[Tuple[str, int, int], ...] = ()
    # state fields left out of ``stable-carry``: (field, why)
    carry_exempt: Tuple[Tuple[str, str], ...] = ()


def generator(device):
    """A ``torch.Generator`` for a build's draws: on ``device``, or on the
    CPU for fake tensors of a device with no generator of its own (meta,
    or CUDA on a build of PyTorch without it); fake tensors take it."""
    import torch
    dev = torch.device(device)
    if dev.type == "meta" or (dev.type == "cuda"
                              and not torch.cuda.is_available()):
        dev = torch.device("cpu")
    return torch.Generator(device=dev).manual_seed(0)


def place(tree, device):
    """``tree`` (dataclasses, dicts, lists and tuples of tensors) with
    every tensor moved to ``device`` and every generator replaced by
    :func:`generator`'s: a build makes its operands on the CPU (the host
    builders resolve "cuda" only where a card is) and places them."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.Generator):
        return generator(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: place(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    return tree


class SphereReward:
    """The toy reward of the NetES entry points: −‖θ‖², no episode
    draws."""

    def __call__(self, params, evals):
        return -(params * params).sum(dim=-1)

    def draw(self, generator, n):
        return None


def toy_state(device, n: int = 8, d: int = 16):
    """A NetES population of n agents of d parameters on ``device``."""
    from repro_torch.core import netes
    return place(netes.init_state(n, d, seed=0, device="cpu"), device)


def toy_topology(device, n: int = 8):
    """An Erdős–Rényi graph (p = 0.5, seed 0) on ``device``."""
    from repro_torch.core import topology_repr
    from repro_torch.core.topology import TopologySpec
    spec = TopologySpec(family="erdos_renyi", n_agents=n, p=0.5, seed=0)
    return place(topology_repr.from_spec(spec, device="cpu"), device)


def iter_entry_points() -> List[EntryPoint]:
    """Collect every hooked module's entry points. Import errors are not
    swallowed: a hooked module that stops importing is itself a finding
    the CLI surfaces (the registry must always be traceable)."""
    eps: List[EntryPoint] = []
    seen: Dict[str, str] = {}
    for modname in HOOKED_MODULES:
        mod = importlib.import_module(modname)
        for ep in mod.analysis_entry_points():
            if ep.name in seen:
                raise ValueError(
                    f"duplicate entry point {ep.name!r} "
                    f"({seen[ep.name]} and {modname})")
            seen[ep.name] = modname
            eps.append(ep)
    return eps
