"""Candidate encoding and theory-prior seeding for the topology search.

The port of ``repro.search.candidates``, with its own copy of the module (it
imports the port's specs and priors). A search candidate is a serializable
``CandidateSpec``: a ``TopologySpec`` (family × density × graph seed), an
optional ``ScheduleSpec`` (time-varying topologies search too) and an
optional ``ChannelSpec`` (DESIGN.md §11: the tournament co-optimizes the
graph and its compression and fault regime). ``make_grid`` expands the
cross product, dropping combinations the schedule compiler would reject
(``rotate_circulant`` over a non-circulant family); ``seed_pool`` ranks the
grid by the Lemma 7.2 theory prior (``core.theory.prior_score``) and keeps
the top ``pool_size``, always keeping the requested control families (the
fully connected baseline must survive pruning: the tournament's win
condition is to beat it, DESIGN.md §10). The pool and its order are the
reference's, label for label.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..comm.channel import ChannelSpec
from ..core import theory
from ..core.topology import TopologySpec
from ..core.topology_sched import ScheduleSpec

# Families with no density knob: one candidate each, independent of the
# (densities × seeds) axes of the grid.
CONTROL_FAMILIES = ("fully_connected", "disconnected", "star", "ring")

# Families whose generators are exactly circulant: the only legal bases
# for a rotate_circulant schedule.
CIRCULANT_FAMILIES = ("circulant_erdos_renyi", "ring")


@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """One point in the search space (serializable, hashable)."""

    topo: TopologySpec
    sched: Optional[ScheduleSpec] = None
    chan: Optional[ChannelSpec] = None

    @property
    def scheduled(self) -> bool:
        return self.sched is not None and self.sched.kind != "static"

    @property
    def channeled(self) -> bool:
        return self.chan is not None and not self.chan.lossless

    def effective_p(self) -> float:
        """The edge density the theory prior sees: the closed forms are
        parameterized by G(n, p) density, and the controls get their
        structural density."""
        n = max(self.topo.n_agents, 2)
        fam = self.topo.family
        if fam == "fully_connected":
            return 1.0
        if fam == "disconnected":
            return 0.0
        if fam == "star":
            return 2.0 / n
        if fam == "ring":
            return 2.0 / (n - 1)
        return self.topo.p

    def label(self) -> str:
        """Stable human-readable id (the search history's keys)."""
        t = self.topo
        s = t.family if t.family in CONTROL_FAMILIES else \
            f"{t.family}:p={t.p:g}:s={t.seed}"
        if self.scheduled:
            s += f"+{self.sched.kind}"
        if self.channeled:
            s += f"+{self.chan.label()}"
        return s


def _schedule_compatible(family: str, sched: Optional[ScheduleSpec]) -> bool:
    if sched is None or sched.kind == "static":
        return True
    if sched.kind == "rotate_circulant":
        return family in CIRCULANT_FAMILIES
    # anneal_density and resample_er redraw ER graphs over a dense or
    # sparse payload: any base family works, but redrawing away from a
    # control graph makes the control meaningless, so no schedule on one.
    return family not in CONTROL_FAMILIES


def make_grid(n_agents: int,
              families: Sequence[str],
              densities: Sequence[float],
              seeds: Sequence[int] = (0,),
              schedules: Sequence[Union[ScheduleSpec, str, None]] = (None,),
              channels: Sequence[Union[ChannelSpec, str, None]] = (None,),
              ) -> List[CandidateSpec]:
    """The cross product families × densities × seeds × schedules ×
    channels, with each control family collapsed to one candidate and
    incompatible (family, schedule) pairs dropped, in a deterministic
    order. A ``static`` schedule and a ``lossless`` channel collapse to
    None (the same program, one candidate)."""
    parsed: List[Optional[ScheduleSpec]] = []
    for s in schedules:
        if isinstance(s, str):
            s = ScheduleSpec.parse(s)
        if s is not None and s.kind == "static":
            s = None
        if s not in parsed:
            parsed.append(s)
    chans: List[Optional[ChannelSpec]] = []
    for c in channels:
        if isinstance(c, str):
            c = ChannelSpec.parse(c)
        if c is not None and c.lossless:
            c = None
        if c not in chans:
            chans.append(c)
    out: List[CandidateSpec] = []
    for family in families:
        if family in CONTROL_FAMILIES:
            axes = [(1.0, seeds[0] if seeds else 0)]
        else:
            axes = [(p, s) for p in densities for s in seeds]
        for p, seed in axes:
            for sched in parsed:
                if not _schedule_compatible(family, sched):
                    continue
                for chan in chans:
                    cand = CandidateSpec(
                        topo=TopologySpec(family=family, n_agents=n_agents,
                                          p=p, seed=seed),
                        sched=sched, chan=chan)
                    if cand not in out:
                        out.append(cand)
    return out


def prior_scores(cands: Sequence[CandidateSpec]) -> np.ndarray:
    """The theory prior of each candidate (higher ⇒ seeded earlier): one
    float32 ``prior_score`` evaluation on the CPU, no graph built."""
    if not cands:
        return np.zeros((0,), np.float64)
    n = torch.tensor([c.topo.n_agents for c in cands], dtype=torch.float32)
    p = torch.tensor([c.effective_p() for c in cands], dtype=torch.float32)
    return theory.prior_score(n, p).numpy().astype(np.float64)


def seed_pool(cands: Sequence[CandidateSpec], pool_size: int,
              keep_families: Tuple[str, ...] = ("fully_connected",),
              ) -> List[CandidateSpec]:
    """The grid pruned to ``pool_size`` by theory prior, keeping one
    candidate of each ``keep_families`` control. Returns the pool in
    descending-prior order, ties broken by grid position."""
    cands = list(cands)
    if pool_size >= len(cands):
        return cands
    scores = prior_scores(cands)
    order = sorted(range(len(cands)), key=lambda i: (-scores[i], i))
    forced = []
    for fam in keep_families:
        idx = next((i for i in range(len(cands))
                    if cands[i].topo.family == fam), None)
        if idx is not None and idx not in forced:
            forced.append(idx)
    keep = list(forced)
    for i in order:
        if len(keep) >= max(pool_size, len(forced)):
            break
        if i not in keep:
            keep.append(i)
    # the pool in prior order (the forced controls by their own prior)
    keep.sort(key=lambda i: (-scores[i], i))
    return [cands[i] for i in keep]
