"""On-device probe pipeline — ``ProbeSpec`` → ``Probes`` → ``MetricsState``
(DESIGN.md §15). The port of ``repro.obs.probes``.

A serializable spec compiles into a hashable ``Probes``, whose state — a
fixed-capacity ring of per-iteration samples on the run's device plus a
write cursor — travels beside the NetES state. Each step writes one column
with no host read, so a probed step loop keeps the unprobed loop's
properties: no host sync, and capturable as one CUDA graph. The whole
series leaves the device in ONE transfer at drain time
(``obs.cuda_watch.device_get``).

Probes are PURE READS of the step's metrics dict (and, for the graph stage,
the live topology): they draw nothing, change no training state, and add no
dataflow edge into the trajectory, so a probed run equals the unprobed run
bit for bit (tests/test_torch_obs.py). With ``probes=None`` every call site
takes its unprobed branch.

Stages (pipe-composable, ``"fitness|wire|graph"``):

* ``fitness``   — population reward mean / best / dispersion (std)
* ``consensus`` — consensus distance Σ_d Var_i[θ_i] and the Thm 7.1
  update-variance proxy
* ``wire``      — realized messages + bytes, event-trigger fraction,
  dropout drop fraction (needs a channel-carrying run)
* ``graph``     — live-topology health: density, degree min/max, and the
  Lemma 7.2 reachability proxy (``core.theory.reachability_prior``)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.topology_sched import graph_signals
from .cuda_watch import device_get

STAGES: Dict[str, Tuple[str, ...]] = {
    "fitness": ("fitness_mean", "fitness_best", "fitness_std"),
    "consensus": ("consensus_dist", "update_var"),
    "wire": ("msgs", "wire_bytes", "trigger_frac", "drop_frac"),
    "graph": ("density", "deg_min", "deg_max", "reach_proxy"),
}

DEFAULT_CAPACITY = 512


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Serializable probe pipeline: which signal families to record."""
    stages: Tuple[str, ...] = ("fitness", "consensus")

    def __post_init__(self):
        if not self.stages:
            raise ValueError("ProbeSpec needs at least one stage")
        seen = set()
        for st in self.stages:
            if st not in STAGES:
                raise ValueError(f"unknown probe stage {st!r} "
                                 f"(have {sorted(STAGES)})")
            if st in seen:
                raise ValueError(f"duplicate probe stage {st!r}")
            seen.add(st)

    @classmethod
    def parse(cls, text: str) -> "ProbeSpec":
        """``"fitness|wire"`` → ProbeSpec; ``"all"`` → every stage."""
        text = text.strip()
        if text == "all":
            return cls(stages=tuple(STAGES))
        return cls(stages=tuple(s.strip() for s in text.split("|")
                                if s.strip()))

    def label(self) -> str:
        return "|".join(self.stages)


@dataclasses.dataclass
class MetricsState:
    """The ring: ``buf (S, capacity)`` float32 columns in write order and
    ``cursor`` a 0-d int32 tensor = TOTAL samples ever written (the ring
    slot is ``cursor % capacity``; ``cursor > capacity`` means the oldest
    ``cursor − capacity`` samples were overwritten). Both on the run's
    device. Unlike the reference's functional ring, ``Probes.record``
    (and so every probed step) updates them IN PLACE, as a captured CUDA
    graph needs: a caller that wants the ring as it was keeps a clone."""
    buf: torch.Tensor
    cursor: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Probes:
    """Compiled, hashable probe pipeline.

    ``msg_bytes`` is the per-message payload size for the wire stage's
    bytes series (``channel.payload_bytes(dim)``); 0.0 when no channel is
    attached, in which case the wire stage is rejected at compile time.
    """
    spec: ProbeSpec
    capacity: int = DEFAULT_CAPACITY
    msg_bytes: float = 0.0

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be ≥ 1, got {self.capacity}")

    # -- derived ----------------------------------------------------------
    @property
    def signals(self) -> Tuple[str, ...]:
        return tuple(s for st in self.spec.stages for s in STAGES[st])

    @property
    def n_signals(self) -> int:
        return len(self.signals)

    def label(self) -> str:
        return f"{self.spec.label()}@{self.capacity}"

    # -- state ------------------------------------------------------------
    def init(self, device: Union[str, torch.device] = "cuda"
             ) -> MetricsState:
        """The t = 0 ring on ``device``; it checkpoints through
        ``checkpoint.io`` like any other state."""
        return MetricsState(
            buf=torch.zeros((self.n_signals, self.capacity),
                            dtype=torch.float32, device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device))

    # -- on the device ------------------------------------------------------
    def sample(self, metrics: Dict[str, Any], topo=None) -> torch.Tensor:
        """One (S,) float32 sample vector from a step's metrics dict (+ the
        live topology for the graph stage). Pure read: no draw, no state.
        A missing input raises a stage-named error."""
        vals = []
        for st in self.spec.stages:
            if st == "fitness":
                vals += [_get(metrics, "reward_mean", st),
                         _get(metrics, "reward_max", st),
                         _get(metrics, "reward_std", st)]
            elif st == "consensus":
                vals += [_get(metrics, "theta_spread", st),
                         _get(metrics, "update_var", st)]
            elif st == "wire":
                msgs = _get(metrics, "msgs", st)
                drop = metrics.get("drop_frac")
                if drop is None:
                    drop = torch.zeros((), dtype=torch.float32,
                                       device=msgs.device)
                vals += [msgs, msgs * float(np.float32(self.msg_bytes)),
                         _get(metrics, "trigger_frac", st), drop]
            else:  # graph
                if topo is None:
                    raise ValueError(
                        "probe stage 'graph' needs the live topology; "
                        "this call site does not thread one")
                g = graph_signals(topo)
                vals += [g["density"], g["deg_min"], g["deg_max"],
                         g["reach_proxy"]]
        return torch.stack([v.to(torch.float32) for v in vals])

    def record(self, mstate: MetricsState, metrics: Dict[str, Any],
               topo=None) -> MetricsState:
        """Write one sample column into the ring, in place, and return it.
        The slot index stays on the device: ``buf[:, cursor % cap]`` with a
        0-d device index would read it on the host, ``index_copy_`` with a
        one-element index tensor does not."""
        col = self.sample(metrics, topo)[:, None]
        slot = torch.remainder(mstate.cursor, self.capacity).reshape(1)
        mstate.buf.index_copy_(1, slot.long(), col)
        mstate.cursor.add_(1)
        return mstate

    # -- host -------------------------------------------------------------
    def drain(self, mstate: MetricsState) -> Dict[str, Any]:
        """ONE host transfer: pull the ring, unroll to chronological
        order, return ``{signal: (T,) np.ndarray}`` plus bookkeeping
        (``cursor`` = total recorded, ``dropped`` = overwritten)."""
        buf, cursor = device_get((mstate.buf, mstate.cursor))
        buf = buf.numpy()
        total = int(cursor)
        cap = self.capacity
        if total <= cap:
            vals = buf[:, :total]
        else:
            vals = np.roll(buf, -(total % cap), axis=1)
        out: Dict[str, Any] = {"cursor": total,
                               "dropped": max(0, total - cap)}
        for i, name in enumerate(self.signals):
            out[name] = vals[i]
        return out


def _get(metrics: Dict[str, Any], key: str, stage: str):
    if key not in metrics:
        raise KeyError(
            f"probe stage {stage!r} needs metric {key!r}, which this run "
            f"does not produce (have {sorted(metrics)}; e.g. 'wire' needs "
            "a channel-carrying step)")
    return metrics[key]


def compile_probes(spec: Optional[Union[ProbeSpec, str]],
                   capacity: int = DEFAULT_CAPACITY,
                   channel=None, dim: Optional[int] = None
                   ) -> Optional[Probes]:
    """Spec (or ``"fitness|wire"`` string sugar, or None) → ``Probes``.

    ``channel``/``dim`` bind the wire stage's bytes-per-message factor;
    requesting ``wire`` without a channel is an error (the run would have
    no traffic to measure)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = ProbeSpec.parse(spec)
    msg_bytes = 0.0
    if "wire" in spec.stages:
        if channel is None:
            raise ValueError(
                "probe stage 'wire' needs a channel (there is no realized "
                "traffic to measure on a channel-free run)")
        if dim is not None:
            msg_bytes = float(channel.payload_bytes(dim))
    return Probes(spec=spec, capacity=int(capacity), msg_bytes=msg_bytes)


def analysis_entry_points():
    """Contract-linter entry points: the PROBED run drivers at toy size.
    The unprobed programs are linted by their owning module
    (``core.netes``); these run the same steps with the probe ring
    recorded into, so the linter holds the ring to the same contracts: no
    host sync in the instrumented step, and a ring (and cursor) that keeps
    its dtype, shape and device."""
    from ..analysis.registry import (EntryPoint, SphereReward, place,
                                     toy_state, toy_topology)
    from ..core import netes

    def build_run_probed(device):
        cfg = netes.NetESConfig()
        probes = compile_probes("fitness|consensus", capacity=16)
        return (lambda s, a, ms: netes.run(
                    s, a, SphereReward(), cfg, 3, probes=probes,
                    metrics_state=ms),
                (toy_state(device), toy_topology(device),
                 probes.init(device)), {})

    def build_run_q8_probed(device):
        from ..comm.channel import compile_channel
        cfg = netes.NetESConfig()
        chan = compile_channel("quantize(bits=8)", 8)
        probes = compile_probes("all", capacity=16, channel=chan, dim=16)
        state = toy_state(device)
        return (lambda s, a, c, ms: netes.run(
                    s, a, SphereReward(), cfg, 3, chan, c, probes=probes,
                    metrics_state=ms),
                (state, toy_topology(device), chan.init(state.thetas),
                 probes.init(device)), {})

    def build_run_scheduled_probed(device):
        cfg = netes.NetESConfig()
        schedule = netes.toy_schedule()
        probes = compile_probes("fitness|graph", capacity=16)
        return (lambda s, t, ms: netes.run_scheduled(
                    s, t, SphereReward(), cfg, schedule, 3, probes=probes,
                    metrics_state=ms),
                (toy_state(device),
                 place(schedule.init(device="cpu"), device),
                 probes.init(device)), {})

    host_t = (("t", "the schedule's iteration counter lives on the host: "
                    "a scheduled step is not captured"),)
    return (
        EntryPoint(name="obs.netes.run.probed", build=build_run_probed,
                   carry=(("state", 0, 0), ("ring", 2, 2))),
        EntryPoint(name="obs.netes.run.q8.probed",
                   build=build_run_q8_probed,
                   carry=(("state", 0, 0), ("chan", 2, 1), ("ring", 3, 2))),
        EntryPoint(name="obs.netes.run_scheduled.probed",
                   build=build_run_scheduled_probed,
                   carry=(("state", 0, 0), ("sched", 1, 1), ("ring", 2, 3)),
                   carry_exempt=host_t),
    )
