"""The paper's experiment: NetES over a population on an RL task (or a
synthetic landscape), with the §5.2 evaluation protocol — periodic
noise-free evaluation of the best perturbed parameters seen so far; and
NetES over LM agents (``train_lm_netes``), each agent a replica of a
registry model trained on the synthetic corpus.

The port of ``repro.train.loop``. Steps run one after another on
the device; their metrics stay there and are drained to the host once per
chunk of ``METRIC_DRAIN_CHUNK`` iterations and at eval points. With
``TrainConfig.channel`` every inter-agent message rides a lossy channel
(``comm.channel``), and the history gains the realized traffic. With
``TrainConfig.schedule`` the graph anneals, resamples or rotates between
iterations (``core.topology_sched``). With ``TrainConfig.checkpoint_dir``
the run saves its state at every eval point and resumes from the last one.
With ``TrainConfig.probes`` a probe ring on the device records the chosen
signals every step and drains once at the end (``obs.probes``); with
``TrainConfig.trace`` the run writes a JSONL trace of its chunks, steps,
drains, evals and checkpoints (``obs.trace``). ``search_topology`` runs a
topology-search tournament first (``search``, DESIGN.md §10), and
``TrainConfig.from_search_result`` trains on its winner. With
``TrainConfig.shards`` the RL run is sharded over the ranks of a process
group (``distributed.fleet_shard``, DESIGN.md §13): each chunk of
iterations is one ``netes.run(mesh=)``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import checkpoint
from .._device import resolve_device
from ..comm.channel import Channel, ChannelSpec, compile_channel
from ..configs.base import ModelConfig
from ..core import es_utils, netes, topology_repr
from ..core.netes import Draws, NetESConfig, NetESState
from ..core.topology import TopologySpec
from ..core.tree import flatten
from ..core.topology_sched import (ScheduleSpec, TopologySchedule,
                                   compile_schedule)
from ..data import batch_seed, make_batch
from ..distributed import fleet_shard, netes_dist
from ..envs import resolve_task
from ..envs.rollout import evaluate_best
from ..obs import (DEFAULT_CAPACITY, Probes, ProbeSpec, Trace,
                   compile_probes, device_get)
from ..search import SearchConfig, run_search

# Iterations whose device metrics accumulate before one host transfer.
METRIC_DRAIN_CHUNK = 8


@dataclasses.dataclass
class TrainConfig:
    n_agents: int = 32
    iters: int = 100
    # The topology travels as a TopologySpec; (family, density, seed) is
    # constructor sugar folded into ``topology`` in __post_init__.
    topology: Optional[TopologySpec] = None
    representation: str = "auto"    # auto | dense | sparse | circulant
    topology_family: str = "erdos_renyi"
    density: float = 0.5
    topo_seed: int = 0
    seed: int = 0
    eval_every: int = 0             # 0 ⇒ paper protocol (prob 0.08)
    eval_episodes: int = 16
    netes: NetESConfig = dataclasses.field(default_factory=NetESConfig)
    # Lossy communication channel (DESIGN.md §11): a ChannelSpec, or its
    # string form ("quantize(bits=8)|dropout(p=0.1)"). None ⇒ the
    # channel-free path, which "lossless" reproduces bit for bit.
    channel: Optional[Union[ChannelSpec, str]] = None
    # Fused wire-form dispatch for quantizing channels (DESIGN.md §12);
    # False keeps the decode-then-contract path. Same semantics either way.
    channel_fused: bool = True
    # Time-varying topology (DESIGN.md §9): a ScheduleSpec, or its string
    # form ("resample_er(period=8)", ...). None ⇒ the graph never changes.
    schedule: Optional[Union[ScheduleSpec, str]] = None
    # When set, train_rl_netes saves its state (NetES, eval generator,
    # schedule, channel) at every eval point and resumes from
    # ``latest.json`` there if one exists.
    checkpoint_dir: Optional[str] = None
    # On-device telemetry (DESIGN.md §15): a ProbeSpec, or its string form
    # ("fitness|consensus|graph", or "all"). A probed run equals the
    # unprobed one bit for bit; the drained series lands in
    # ``history["probes"]``. None ⇒ no ring.
    probes: Optional[Union[ProbeSpec, str]] = None
    # Ring capacity; 0 ⇒ obs.probes.DEFAULT_CAPACITY. The drained series
    # holds the LAST ``capacity`` iterations in order.
    probe_capacity: int = 0
    # Path of a JSONL run trace (obs/trace.py). None ⇒ no trace file.
    trace: Optional[str] = None
    # Shard the agent axis over this many ranks of a process group
    # (DESIGN.md §13; RL only): each chunk of iterations runs through
    # distributed.fleet_shard, with halo / all-gather collectives between
    # the ranks. Trajectories are identical for ANY shard count (1
    # included), and differ from the unsharded steps only in the rounding
    # of the contraction. None ⇒ netes_step on one device.
    shards: Optional[int] = None

    def __post_init__(self):
        if self.topology is None:
            self.topology = TopologySpec(
                family=self.topology_family, n_agents=self.n_agents,
                p=self.density, seed=self.topo_seed)
        else:
            self.n_agents = self.topology.n_agents
            self.topology_family = self.topology.family
            self.density = self.topology.p
            self.topo_seed = self.topology.seed
        if isinstance(self.channel, str):
            self.channel = ChannelSpec.parse(self.channel)
        if isinstance(self.schedule, str):
            self.schedule = ScheduleSpec.parse(self.schedule)
        if isinstance(self.probes, str):
            self.probes = ProbeSpec.parse(self.probes)

    @classmethod
    def from_search_result(cls, result, **overrides) -> "TrainConfig":
        """A TrainConfig from a ``search.SearchResult``: the tournament's
        winning topology (and its schedule and channel, if the winner was
        a time-varying or lossy-link candidate) becomes the run's
        communication graph. Any field can be overridden (``iters``,
        ``seed``, ``netes``, ...)."""
        kw = dict(topology=result.topology, schedule=result.schedule,
                  channel=result.channel)
        kw.update(overrides)
        return cls(**kw)


def build_topology(tc: TrainConfig,
                   device: Union[str, torch.device] = "cuda"
                   ) -> topology_repr.Topology:
    """TopologySpec → representation-selected Topology on ``device``. The
    run's channel biases ``auto``: a fused-eligible quantizing channel
    raises the sparse cutoff (DESIGN.md §12)."""
    return topology_repr.from_spec(tc.topology,
                                   representation=tc.representation,
                                   device=device, channel=build_channel(tc))


def build_schedule(tc: TrainConfig) -> Optional[TopologySchedule]:
    """``tc.schedule`` compiled against the run's topology spec, or None
    for a run on a fixed graph."""
    if tc.schedule is None:
        return None
    return compile_schedule(tc.schedule, tc.topology, tc.representation)


def build_adjacency(tc: TrainConfig,
                    device: Union[str, torch.device] = "cuda"
                    ) -> torch.Tensor:
    """The dense (N, N) float32 adjacency of ``tc.topology`` on ``device``,
    for graph-statistics consumers."""
    return torch.as_tensor(tc.topology.build(), dtype=torch.float32,
                           device=resolve_device(device))


def build_channel(tc: TrainConfig) -> Optional[Channel]:
    """``tc.channel`` compiled for the run's population, or None for a
    channel-free run."""
    if tc.channel is None:
        return None
    return compile_channel(tc.channel, tc.n_agents, fused=tc.channel_fused)


def build_probes(tc: TrainConfig, channel: Optional[Channel] = None,
                 dim: Optional[int] = None) -> Optional[Probes]:
    """``tc.probes`` compiled for the run (None for an unprobed run).
    ``probe_capacity == 0`` means ``DEFAULT_CAPACITY``, deliberately not a
    function of ``tc.iters``, so a run resumed with a longer horizon
    restores its ring shape for shape."""
    if tc.probes is None:
        return None
    capacity = (tc.probe_capacity if tc.probe_capacity > 0
                else DEFAULT_CAPACITY)
    return compile_probes(tc.probes, capacity=capacity, channel=channel,
                          dim=dim)


def eval_iterations(tc: TrainConfig) -> List[int]:
    """The §5.2 eval points, decided up front on the host: a fixed cadence,
    or each iteration with probability 0.08 from
    ``np.random.default_rng(seed + 999)``; the last iteration always."""
    if tc.eval_every:
        its = list(range(tc.eval_every - 1, tc.iters, tc.eval_every))
    else:
        draw = np.random.default_rng(tc.seed + 999)
        its = [it for it in range(tc.iters) if draw.random() < 0.08]
    if tc.iters > 0 and tc.iters - 1 not in its:
        its.append(tc.iters - 1)
    return its


def train_rl_netes(task: str, tc: TrainConfig,
                   log: Optional[Callable[[Dict], None]] = None, *,
                   device: Union[str, torch.device] = "cuda",
                   state: Optional[NetESState] = None,
                   step_draws: Optional[Callable[[int], Draws]] = None,
                   eval_draws: Optional[Callable[[int], torch.Tensor]] = None
                   ) -> Dict:
    """The paper experiment. ``task``: env name or 'landscape:<name>'.

    Returns a history dict: per-iteration ``reward_mean``/``reward_max``,
    the eval trace ``eval``/``eval_iter``, ``final_eval``, ``max_eval`` and
    ``wall_s``. With ``tc.channel`` it also holds the per-iteration
    realized messages ``msgs`` (and the channel's ``drop_frac`` and
    ``trigger_frac``), and the totals ``realized_msgs`` and
    ``realized_wire_bytes`` (messages × the encoded bytes of one message).
    With ``tc.probes`` it holds ``probes``, the ring drained once at the
    end: ``{signal: (T,) np.ndarray, "cursor", "dropped"}``.

    With ``tc.schedule`` each iteration is a ``netes.scheduled_step``: the
    graph in force, then the schedule's advance. With
    ``tc.checkpoint_dir`` the NetES state (its generator included), the
    eval generator, and the schedule's, channel's and probe ring's states
    are saved at every eval point; a call that finds ``latest.json`` there
    resumes after that eval point, bit for bit, and its history covers
    only the iterations after it. With ``tc.trace`` the run writes its
    spans: ``chunk`` (the steps between two drains or eval points, with
    ``iters``) holding one ``step`` a step, ``eval``, ``checkpoint`` and
    ``drain`` (``what`` = ``metrics``, ``eval`` or ``probes``; one host
    transfer each).

    With ``tc.shards`` the run joins the process group of that many ranks
    (``fleet_shard.build_mesh``: under ``torchrun``, or a world of one)
    and runs each chunk sharded; every rank holds the gathered state and
    evaluates it, rank 0 alone writes the checkpoints and the trace.

    ``state`` replaces the initial population drawn from ``tc.seed`` (the
    tests start from the reference's θ⁽⁰⁾). ``step_draws(it)`` and
    ``eval_draws(it)`` replace the draws of iteration ``it`` (under a
    schedule, its uniform redraw too) and of the eval at ``it`` (for an RL
    task, reset states (E, S)); absent, they come from generators seeded
    with ``tc.seed``, ``tc.seed + 999`` and the schedule's seed.
    """
    dev = resolve_device(device)
    mesh = None
    if tc.shards is not None:
        if step_draws is not None:
            raise ValueError("a sharded run draws its own steps")
        mesh = fleet_shard.build_mesh(tc.shards, device=dev)
        dev = mesh.device
    try:
        return _train_rl(task, tc, log, dev, mesh, state, step_draws,
                         eval_draws)
    finally:
        if mesh is not None:
            mesh.close()


def _train_rl(task, tc, log, dev, mesh, state, step_draws, eval_draws):
    lead = mesh is None or mesh.rank == 0
    reward_fn, dim, init_fn, env, policy = resolve_task(task)
    schedule = build_schedule(tc)
    if schedule is not None:
        topo, sstate = None, schedule.init(device=dev)
    else:
        topo, sstate = build_topology(tc, device=dev), None
    if state is None:
        state = netes.init_state(tc.n_agents, dim, seed=tc.seed,
                                 init_fn=init_fn, device=dev)
    channel = build_channel(tc)
    cstate = channel.init(state.thetas) if channel is not None else None
    probes = build_probes(tc, channel=channel, dim=dim)
    mstate = probes.init(dev) if probes is not None else None
    eval_gen = torch.Generator(device=dev).manual_seed(tc.seed + 999)

    ckpt_dir = (pathlib.Path(tc.checkpoint_dir) if tc.checkpoint_dir
                else None)
    start = 0
    if ckpt_dir is not None and (ckpt_dir / "latest.json").exists():
        done, blob = checkpoint.restore_train_state(ckpt_dir, {
            "netes": state, "eval_gen": eval_gen, "sched": sstate,
            "chan": cstate, "obs": mstate})
        state, eval_gen = blob["netes"], blob["eval_gen"]
        sstate, cstate, mstate = blob["sched"], blob["chan"], blob["obs"]
        start = done + 1

    history: Dict[str, List] = {"reward_mean": [], "reward_max": [],
                                "eval": [], "eval_iter": []}
    drained = ["reward_mean", "reward_max"]
    if channel is not None:
        drained += ["msgs", "drop_frac", "trigger_frac"]
        history.update({k: [] for k in drained[2:]})
    tr = Trace(tc.trace if lead else None, name=f"rl:{task}", device=dev,
               task=task,
               n_agents=tc.n_agents, iters=tc.iters,
               probes=None if probes is None else probes.spec.label())
    t0 = time.time()

    pending: List[Dict[str, torch.Tensor]] = []
    evals_pending: List = []

    def drain():
        """One host transfer for the pending metrics and eval scores."""
        if not pending and not evals_pending:
            return
        what = "eval" if evals_pending else "metrics"
        with tr.span("drain", what=what, iters=len(pending),
                     points=len(evals_pending)):
            payload = []
            if pending:
                payload.append(torch.stack([
                    torch.stack([m[k].float() for k in drained])
                    for m in pending]))
            if evals_pending:
                payload.append(torch.stack([s for _, s in evals_pending])
                               .float())
            host = list(device_get(payload))
            if pending:
                stacked = host.pop(0).double()
                for c, k in enumerate(drained):
                    history[k].extend(stacked[:, c].tolist())
                pending.clear()
            if evals_pending:
                history["eval"].extend(host.pop(0).double().tolist())
                history["eval_iter"].extend(it for it, _ in evals_pending)
                evals_pending.clear()

    def step(it: int) -> None:
        # the probe ring mstate is updated in place by the step
        nonlocal state, sstate, cstate
        draws = step_draws(it) if step_draws is not None else None
        kw = dict(channel=channel, chan_state=cstate, probes=probes,
                  metrics_state=mstate)
        if schedule is None:
            state, cstate, metrics = netes.step_parts(netes.netes_step(
                state, topo, reward_fn, tc.netes, draws, **kw))
        else:
            state, sstate, cstate, metrics = netes.step_parts(
                netes.scheduled_step(state, sstate, reward_fn, tc.netes,
                                     schedule, draws, **kw), scheduled=True)
        pending.append(metrics)

    def run_sharded(first: int, last: int) -> None:
        """Iterations first .. last as one sharded run (a single step is a
        run of 1); the probe ring mstate is updated in place."""
        nonlocal state, sstate, cstate
        kw = dict(channel=channel, chan_state=cstate, probes=probes,
                  metrics_state=mstate, mesh=mesh)
        k = last - first + 1
        if schedule is None:
            state, cstate, metrics = netes.step_parts(netes.run(
                state, topo, reward_fn, tc.netes, k, **kw))
        else:
            state, sstate, cstate, metrics = netes.step_parts(
                netes.run_scheduled(state, sstate, reward_fn, tc.netes,
                                    schedule, k, **kw), scheduled=True)
        pending.extend({key: v[i] for key, v in metrics.items()}
                       for i in range(k))

    eval_its = sorted(i for i in eval_iterations(tc) if i >= start)
    try:
        it = start
        while it < tc.iters:
            # the steps up to the next eval point or a full chunk
            stop = min([tc.iters - 1, it + METRIC_DRAIN_CHUNK
                        - len(pending) - 1] + [e for e in eval_its
                                               if e >= it][:1])
            with tr.span("chunk", iters=stop - it + 1):
                if mesh is not None:
                    run_sharded(it, stop)
                else:
                    for i in range(it, stop + 1):
                        with tr.span("step", iter=i):
                            step(i)
            it = stop + 1
            at_eval = stop in eval_its
            if at_eval:
                resets = eval_draws(stop) if eval_draws is not None else None
                with tr.span("eval", iter=stop):
                    if env is not None:
                        score = evaluate_best(env, policy, state.best_theta,
                                              resets,
                                              episodes=tc.eval_episodes,
                                              generator=eval_gen)
                    else:
                        if resets is None:
                            resets = reward_fn.draw(eval_gen, 1)
                        score = reward_fn(state.best_theta[None], resets)[0]
                evals_pending.append((stop, score))
                if ckpt_dir is not None:
                    with tr.span("checkpoint", iter=stop):
                        checkpoint.save_train_state(
                            ckpt_dir, stop,
                            {"netes": state, "eval_gen": eval_gen,
                             "sched": sstate, "chan": cstate, "obs": mstate},
                            extra={"task": task}, mesh=mesh)
            if (len(pending) >= METRIC_DRAIN_CHUNK
                    or (at_eval and log is not None)):
                drain()
            if at_eval and log is not None and lead:
                log({"iter": stop, "eval": history["eval"][-1],
                     "reward_mean": history["reward_mean"][-1]})
        drain()
        if probes is not None:
            with tr.span("drain", what="probes"):
                history["probes"] = probes.drain(mstate)
    finally:
        tr.close()
    history["final_eval"] = history["eval"][-1] if history["eval"] else None
    history["max_eval"] = max(history["eval"]) if history["eval"] else None
    if channel is not None:
        total_msgs = float(np.sum(history["msgs"], dtype=np.float64))
        history["realized_msgs"] = total_msgs
        history["realized_wire_bytes"] = int(
            round(total_msgs * channel.payload_bytes(dim)))
    history["wall_s"] = time.time() - t0
    return history


def search_topology(task: str, sconfig=None,
                    log: Optional[Callable[[Dict], None]] = None, *,
                    device: Union[str, torch.device] = "cuda"
                    ) -> TopologySpec:
    """Optimize the communication graph for ``task`` on ``device`` and
    return the winning ``TopologySpec``: the paper's closing claim, made
    operational (DESIGN.md §10). ``sconfig`` is a ``search.SearchConfig``
    (its defaults if None). For the whole tournament record (the round
    history, the control scores, a winning schedule or channel), call
    ``search.run_search`` and use ``TrainConfig.from_search_result``."""
    result = run_search(task, sconfig or SearchConfig(), log=log,
                        device=device)
    return result.topology


# The streams of an LM run, each seeded with stream_seed(tc.seed, tag, ...):
# the initial parameters, the batches, and the step draws.
LM_INIT, LM_BATCH, LM_STEP = 0, 1, 2


def lm_population(cfg: ModelConfig, tc: TrainConfig, same_init: bool = True,
                  *, device: Union[str, torch.device] = "cuda"):
    """The population ``train_lm_netes`` starts from, seeded with
    ``stream_seed(tc.seed, LM_INIT)``."""
    return netes_dist.init_population(
        cfg, tc.n_agents, es_utils.stream_seed(tc.seed, LM_INIT),
        same_init=same_init, device=resolve_device(device))


def lm_step_inputs(cfg: ModelConfig, tc: TrainConfig, it: int,
                   seq_len: int = 128, per_agent_batch: int = 1, *,
                   device: Union[str, torch.device] = "cuda"):
    """Iteration ``it``'s ``(batch, draws)`` in ``train_lm_netes``: the
    batch's leaves (N, per_agent_batch, ...) — tokens of ``seq_len``, or
    of ``seq_len − num_patches`` beside a vision model's patches, and an
    encoder-decoder's frames — from a generator seeded with
    ``batch_seed(stream_seed(tc.seed, LM_BATCH), it)``, the draws
    ``netes_dist.draw(stream_seed(tc.seed, LM_STEP), it)``."""
    dev = resolve_device(device)
    n = tc.n_agents
    gen = torch.Generator(device=dev).manual_seed(
        batch_seed(es_utils.stream_seed(tc.seed, LM_BATCH), it))
    batch = make_batch(cfg, dict(seq_len=seq_len,
                                 global_batch=n * per_agent_batch), gen)
    batch = {k: v.reshape((n, per_agent_batch) + v.shape[1:])
             for k, v in batch.items()}
    return batch, netes_dist.draw(es_utils.stream_seed(tc.seed, LM_STEP),
                                  it, dev)


def train_lm_netes(cfg: ModelConfig, tc: TrainConfig, seq_len: int = 128,
                   per_agent_batch: int = 1, same_init: bool = True,
                   log: Optional[Callable[[Dict], None]] = None, *,
                   device: Union[str, torch.device] = "cuda") -> Dict:
    """NetES-trains a registry architecture on the synthetic corpus with
    the replica step (``distributed.netes_dist``): N agents, each a whole
    replica, evaluated one after another on ``per_agent_batch`` sequences
    of ``seq_len`` tokens each, mixed by Eq. 3 over the run's graph
    (``tc.topology``, ``tc.representation``, ``tc.schedule``,
    ``tc.channel``).

    ``same_init=True`` (paper Eq. 1/2 regime): all agents start from one
    θ. At LM scale, independently initialized agents make Eq. 3's
    θ-difference term O(weight norm) × α/(Nσ²), divergent for any useful α.

    Returns the history: per-iteration ``loss_mean`` and ``reward_max``,
    drained once every ``METRIC_DRAIN_CHUNK`` iterations; on the card
    ``step_ms``, each step's time between CUDA events on the stream, read
    at the drains; with ``tc.probes`` the drained ``probes``. With
    ``tc.trace`` the run writes ``step`` and ``drain`` spans.

    The run starts from ``lm_population`` and takes iteration ``it``'s
    batch and draws from ``lm_step_inputs``.
    """
    if tc.shards is not None:
        raise ValueError("TrainConfig.shards is for RL runs only "
                         "(train_rl_netes)")
    dev = resolve_device(device)
    n = tc.n_agents
    params = lm_population(cfg, tc, same_init, device=dev)
    schedule = build_schedule(tc)
    channel = build_channel(tc)
    if schedule is not None:
        topo, sstate = None, schedule.init(device=dev)
    else:
        topo, sstate = build_topology(tc, device=dev), None
    dim = sum(leaf[0].numel() for leaf in flatten(params))
    probes = build_probes(tc, channel=channel, dim=dim)
    step = netes_dist.make_replica_train_step(
        cfg, tc.netes, n, microbatch=1, topology=topo, schedule=schedule,
        channel=channel, probes=probes)
    states = [s for s in (sstate,
                          channel.init(params) if channel is not None
                          else None,
                          probes.init(dev) if probes is not None else None)
              if s is not None]
    tr = Trace(tc.trace, name=f"lm:{cfg.name}", device=dev, n_agents=n,
               iters=tc.iters,
               probes=None if probes is None else probes.spec.label())
    history: Dict[str, List] = {"loss_mean": [], "reward_max": []}
    timed = dev.type == "cuda"
    if timed:
        history["step_ms"] = []
    pending: List = []

    def drain():
        if not pending:
            return
        with tr.span("drain", what="metrics", iters=len(pending)):
            host = device_get(torch.stack([
                torch.stack([m["loss_mean"], m["reward_max"]])
                for _, m, _ in pending])).double()
            for (it, _, ev), (loss, rmax) in zip(pending, host.tolist(),
                                                 strict=True):
                history["loss_mean"].append(loss)
                history["reward_max"].append(rmax)
                if timed:
                    history["step_ms"].append(ev[0].elapsed_time(ev[1]))
                if log and it % 10 == 0:
                    log({"iter": it, "loss": loss})
            pending.clear()

    try:
        for it in range(tc.iters):
            batch, draws = lm_step_inputs(cfg, tc, it, seq_len,
                                          per_agent_batch, device=dev)
            ev = None
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with tr.span("step", iter=it):
                out = list(step(params, None, batch, draws, *states))
            if timed:
                ev[1].record()
            params, metrics, states = out[0], out[1], out[2:]
            pending.append((it, metrics, ev))
            if len(pending) >= METRIC_DRAIN_CHUNK:
                drain()
        drain()
        if probes is not None:
            with tr.span("drain", what="probes"):
                history["probes"] = probes.drain(states[-1])
    finally:
        tr.close()
    return history
