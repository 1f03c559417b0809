"""Scheduled (time-varying) communication topologies (DESIGN.md §9).

The port of ``repro.core.topology_sched``. A ``ScheduleSpec`` names how the
graph changes between NetES iterations:

* ``static`` — never;
* ``anneal_density(p_end, horizon)`` — the edge density moves from the base
  spec's p to ``p_end`` over ``horizon`` iterations by re-thresholding ONE
  fixed (N, N) uniform draw, so successive graphs are nested;
* ``resample_er(period)`` — a fresh Erdős–Rényi graph at the base density
  every ``period`` iterations;
* ``rotate_circulant(stride)`` — the circulant's offsets rotate by
  ``stride`` (mod (n−1)//2) every iteration, the degree unchanged.

``compile_schedule`` resolves it against the base ``TopologySpec`` into a
``TopologySchedule``, whose ``init`` builds the t = 0 ``ScheduleState`` and
whose ``advance`` moves it to t + 1. Every shape is kept: a dense refresh
swaps the adjacency, a sparse one re-pads to the schedule's static K_max
(``pad_k_max``), a rotating circulant swaps its host-side shifts.

The iteration ``t`` is a host int, so ``advance`` decides on the host
whether a step redraws and makes no host sync; off-period steps of
``resample_er`` draw nothing. The randomness has one seam: the uniform
(N, N) draw of ``init(u=)`` (``anneal_density``'s fixed draw) and of
``advance(state, u=)`` (``resample_er``'s redraw). Given, it is used as it
is (the tests hand in the reference's threefry draws, and then every graph
equals the reference's exactly); absent, it comes from a generator seeded
with ``spec.seed``, whose state ``ScheduleState`` carries into a
checkpoint. Redraws skip the host generators' connectivity repair, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import math
import re
from fractions import Fraction
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from . import theory, topology_repr
from . import topology as topo_gen
from .topology import TopologySpec
from .topology_repr import Topology

KINDS = ("static", "anneal_density", "resample_er", "rotate_circulant")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Serializable schedule description (``TrainConfig.schedule``)."""

    kind: str = "static"
    period: int = 1              # resample_er: iterations between redraws
    stride: int = 1              # rotate_circulant: offset shift per iter
    p_end: Optional[float] = None  # anneal_density: final density
    horizon: int = 0             # anneal_density: iters to reach p_end
    seed: int = 0                # seed of the schedule's own draws

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown schedule kind {self.kind!r}; "
                             f"available: {KINDS}")
        if self.kind == "resample_er" and self.period < 1:
            raise ValueError("resample_er needs period >= 1")
        if self.kind == "anneal_density":
            if self.p_end is None or self.horizon < 1:
                raise ValueError("anneal_density needs p_end and "
                                 "horizon >= 1")

    @classmethod
    def parse(cls, text: str) -> "ScheduleSpec":
        """``"static" | "resample_er(period=8)" | "anneal_density(
        p_end=0.05,horizon=100)" | "rotate_circulant(stride=3)"``."""
        m = re.fullmatch(r"\s*(\w+)\s*(?:\(([^)]*)\))?\s*", text)
        if not m:
            raise ValueError(f"unparseable schedule {text!r}")
        kind, argstr = m.group(1), m.group(2) or ""
        kw = {}
        for part in filter(None, (p.strip() for p in argstr.split(","))):
            k, _, v = part.partition("=")
            if not _:
                raise ValueError(f"schedule arg {part!r} is not key=value")
            k = k.strip()
            kw[k] = float(v) if k == "p_end" else int(v)
        return cls(kind=kind, **kw)


@dataclasses.dataclass
class ScheduleState:
    """The topology in force for iteration ``t``, and what later steps
    draw from: ``generator`` (``resample_er``'s redraws) and ``u``
    (``anneal_density``'s fixed uniform). The other kinds carry neither."""

    topo: Topology
    t: int
    generator: Optional[torch.Generator] = None
    u: Optional[torch.Tensor] = None


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's weak-typed threshold."""
    return float(np.float32(x))


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> float:
    """a·b + c rounded once to float32 (to nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))

    def rank(x):
        bits = int(np.asarray(x, np.float32).view(np.uint32))
        return abs(Fraction(float(x)) - exact), bits & 1
    return float(min(cands, key=rank))


def er_adjacency(u: torch.Tensor, p: float) -> torch.Tensor:
    """Symmetric self-looped G(n, p) from an (N, N) uniform draw ``u``:
    ``triu(u < p, 1)``, plus its transpose, then the max with the identity.
    No connectivity repair."""
    upper = torch.triu((u < p).to(torch.float32), diagonal=1)
    eye = torch.eye(u.shape[0], dtype=torch.float32, device=u.device)
    return torch.maximum(upper + upper.T, eye)


def pad_k_max(n: int, p: float, observed: int) -> int:
    """Static neighbor-list pad for a schedule that redraws at density
    ``p``: the observed base max-degree or a 4σ binomial tail over the
    n−1 potential neighbors (+ self-loop), whichever is larger."""
    tail = 1 + (n - 1) * p + 4.0 * math.sqrt(max((n - 1) * p * (1 - p),
                                                 0.0))
    return min(n, max(observed, int(math.ceil(tail)) + 1))


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A ``ScheduleSpec`` compiled against its base graph."""

    spec: ScheduleSpec
    base: TopologySpec
    representation: str                 # resolved: dense|sparse|circulant
    n: int
    k_max: int = 0                      # sparse static pad
    base_offsets: Tuple[int, ...] = ()  # rotate_circulant

    def redraws(self, t: int) -> bool:
        """Whether the advance to iteration ``t`` draws a uniform."""
        return self.spec.kind == "resample_er" and t % self.spec.period == 0

    def offsets_at(self, t: int) -> List[int]:
        """``rotate_circulant``'s offsets at iteration ``t``:
        (d − 1 + stride·t) mod m + 1 with m = (n−1)//2."""
        m = max(1, (self.n - 1) // 2)
        return [(d - 1 + self.spec.stride * t) % m + 1
                for d in self.base_offsets]

    def density_at(self, t: int) -> float:
        """``anneal_density``'s threshold at iteration ``t`` ≥ 1,
        p + (p_end − p)·min(t / horizon, 1), in float32 and with the
        roundings of the reference as XLA compiles it: p_end − p in
        float64, then rounded; the division by the constant horizon a
        product with its float32 reciprocal; the product and the sum one
        fused multiply-add. A uniform within an ulp of the threshold
        otherwise lands on the other side of it."""
        f32 = np.float32
        recip = f32(1.0) / f32(self.spec.horizon)
        frac = min(f32(t) * recip, f32(1.0))
        return _fma_f32(f32(self.spec.p_end - self.base.p), frac,
                        f32(self.base.p))

    def _uniform(self, u: Optional[torch.Tensor],
                 generator: Optional[torch.Generator],
                 dev: torch.device) -> torch.Tensor:
        if u is None:
            return torch.rand(self.n, self.n, generator=generator,
                              device=dev)
        if tuple(u.shape) != (self.n, self.n) or u.device != dev:
            raise ValueError(f"injected uniform of shape {tuple(u.shape)} on "
                             f"{u.device}; the schedule takes ({self.n}, "
                             f"{self.n}) on {dev}")
        return u

    def init(self, u: Optional[torch.Tensor] = None,
             device: Union[str, torch.device] = "cuda") -> ScheduleState:
        """The t = 0 state on ``device``. The base graph comes from the
        host generators (connectivity repaired), except for
        ``anneal_density``, whose t = 0 graph lies on its own threshold
        path: ``u`` (or a draw from ``spec.seed``) below p. ``u`` is
        ``anneal_density``'s only."""
        dev = resolve_device(device)
        kind = self.spec.kind
        if u is not None and kind != "anneal_density":
            raise ValueError(f"{kind} draws no uniform at init")
        if kind == "anneal_density":
            gen = torch.Generator(device=dev).manual_seed(self.spec.seed)
            u = self._uniform(u, gen, dev)
            topo = self._refresh(self._template(dev),
                                 er_adjacency(u, _f32(self.base.p)))
            return ScheduleState(topo=topo, t=0, u=u)
        adj = np.asarray(self.base.build(), np.float32)
        if kind == "rotate_circulant":
            topo = Topology(kind="circulant", n=self.n,
                            deg=torch.as_tensor(adj.sum(axis=1), device=dev))
            return ScheduleState(topo=topology_repr.shift_circulant(
                topo, self.base_offsets), t=0)
        gen = (torch.Generator(device=dev).manual_seed(self.spec.seed)
               if kind == "resample_er" else None)
        if self.representation == "sparse":
            idx, mask = topology_repr.sparse_neighbors(
                adj, k_max=self.k_max or None)
            topo = Topology(kind="sparse", n=self.n,
                            deg=torch.as_tensor(adj.sum(axis=1), device=dev),
                            neighbor_idx=torch.as_tensor(idx, device=dev),
                            neighbor_mask=torch.as_tensor(mask, device=dev))
        else:
            topo = topology_repr.from_dense(adj, self.representation,
                                            device=dev)
        return ScheduleState(topo=topo, t=0, generator=gen)

    def _template(self, dev: torch.device) -> Topology:
        """An empty topology of the schedule's shapes, to refresh."""
        n = self.n
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        if self.representation == "sparse":
            return Topology(
                kind="sparse", n=n, deg=zeros,
                neighbor_idx=torch.zeros((n, self.k_max), dtype=torch.int32,
                                         device=dev),
                neighbor_mask=torch.zeros((n, self.k_max),
                                          dtype=torch.float32, device=dev))
        return Topology(kind="dense", n=n, deg=zeros,
                        adj=torch.zeros((n, n), dtype=torch.float32,
                                        device=dev))

    def _refresh(self, topo: Topology, adj: torch.Tensor) -> Topology:
        if self.representation == "sparse":
            return topology_repr.refresh_sparse(topo, adj)
        return topology_repr.refresh_dense(topo, adj)

    def advance(self, state: ScheduleState,
                u: Optional[torch.Tensor] = None) -> ScheduleState:
        """The state of iteration t + 1. ``u`` replaces the uniform of a
        ``resample_er`` redraw (only on a step that redraws, see
        ``redraws``). Makes no host sync."""
        t1 = state.t + 1
        kind = self.spec.kind
        if u is not None and not self.redraws(t1):
            raise ValueError(f"the advance to t = {t1} of {kind} draws no "
                             "uniform")
        if kind == "rotate_circulant":
            topo = topology_repr.shift_circulant(state.topo,
                                                 self.offsets_at(t1))
        elif kind == "anneal_density":
            topo = self._refresh(state.topo,
                                 er_adjacency(state.u, self.density_at(t1)))
        elif self.redraws(t1):
            u = self._uniform(u, state.generator, state.topo.device)
            topo = self._refresh(state.topo,
                                 er_adjacency(u, _f32(self.base.p)))
        else:
            topo = state.topo
        return dataclasses.replace(state, topo=topo, t=t1)


def compile_schedule(spec: Optional[ScheduleSpec], base: TopologySpec,
                     representation: str = "auto") -> TopologySchedule:
    """Resolve (ScheduleSpec × TopologySpec × representation) into a
    ``TopologySchedule``; ``spec=None`` compiles as static.

    ``rotate_circulant`` needs an exactly circulant base graph whose
    offsets lie in [1, (n−1)//2] (so ±d stay distinct under rotation).
    ``anneal_density``/``resample_er`` refresh a dense or sparse payload:
    ``auto`` runs ``select_representation`` on the base graph and maps
    circulant to sparse (a redrawn ER graph has no offsets to keep); the
    sparse pad is ``pad_k_max`` at the higher of the two densities.
    """
    spec = spec or ScheduleSpec()
    n = base.n_agents
    adj = np.asarray(base.build(), np.float32)
    if spec.kind == "rotate_circulant":
        if representation not in ("auto", "circulant"):
            raise ValueError("rotate_circulant schedules require the "
                             f"circulant representation, not "
                             f"{representation!r}")
        offs = topo_gen.circulant_offsets(adj)
        if offs is None or not np.array_equal(
                adj, topo_gen.circulant_from_offsets(n, offs)):
            raise ValueError("rotate_circulant needs an exactly circulant "
                             f"base graph (family {base.family!r} is not)")
        if offs and max(offs) > (n - 1) // 2:
            raise ValueError(
                f"rotate_circulant offsets must lie in [1, (n-1)//2] so "
                f"±d stay distinct under rotation; got {max(offs)} with "
                f"n={n}")
        return TopologySchedule(spec=spec, base=base,
                                representation="circulant", n=n,
                                base_offsets=tuple(offs))
    if spec.kind == "static":
        return TopologySchedule(spec=spec, base=base,
                                representation=representation, n=n)
    rep = representation
    if rep == "auto":
        rep = topology_repr.select_representation(adj)
        if rep == "circulant":
            rep = "sparse"
    if rep == "circulant":
        raise ValueError(f"{spec.kind} schedules redraw arbitrary ER "
                         "graphs — circulant payloads cannot represent "
                         "them; use dense or sparse")
    k_max = 0
    if rep == "sparse":
        p_hi = max(base.p, spec.p_end or 0.0)
        observed = int((adj != 0).sum(axis=1).max())
        k_max = pad_k_max(n, p_hi, observed)
    return TopologySchedule(spec=spec, base=base, representation=rep,
                            n=n, k_max=k_max)


# ---------------------------------------------------------------------------
# topology-health probe signals — DESIGN.md §15
# ---------------------------------------------------------------------------

def graph_signals(topo: Topology) -> dict:
    """Live-graph health series for the ``graph`` probe stage: density
    (self-loops excluded), degree min/max, and the Lemma 7.2 reachability
    proxy ``theory.reachability_prior(n, p̂)`` at the realized density.
    A read of ``topo.deg`` on its device, so it tracks schedules step by
    step; 0-d float32 tensors, no draw, no host read."""
    n = topo.n
    deg = topo.deg.to(torch.float32)
    # topo.deg counts the self-loop; the density/degree series report
    # the communication graph proper (non-self edges only).
    nbrs = deg - 1.0
    density = (nbrs.sum() / (n * (n - 1))) if n > 1 else nbrs.sum()
    return {
        "density": density,
        "deg_min": nbrs.min(),
        "deg_max": nbrs.max(),
        "reach_proxy": theory.reachability_prior(n, density),
    }
