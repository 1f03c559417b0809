"""Topology-search tournaments (DESIGN.md §10).

The port of ``repro.search.tournament``. The paper closes on the claim that
"distributed machine learning algorithms could be made more effective if
the communication topology between learning agents was optimized": this
module does the optimizing. Successive halving drives the outer loop:
every round trains all surviving candidates ``round_iters`` iterations
(doubling per round with ``widen``: the compute freed by halving the pool
goes to the survivors), scores each by a noise-free evaluation of its best
parameters, and keeps the top half. Pool, cohorts, halving, history and
resume are the reference's.

**Cohorts.** Candidates that can train together form a cohort:

* static candidates cohort by representation (dense or sparse; an exact
  circulant maps to sparse) and channel. Each round the cohort is stacked
  (``topology_repr.stack``) so every sparse candidate is widened to the
  cohort's largest K_max, and unstacked into contiguous per-candidate
  payloads;
* scheduled candidates cohort by what ``TopologySchedule.advance`` reads
  (schedule spec, representation, n, base offsets, base density) and
  channel; the cohort's first schedule advances them all, as the
  reference's one jit-static schedule, and their sparse pads are
  harmonised to the cohort's largest ``k_max``.

**The batched round.** The reference trains a cohort as one
``jax.vmap(netes.run)``. The port has no vmap that reaches through its
kernels, and its NetES step is bound by the host in the rollout (≈ 26
launches for each of an episode's 200 steps). So a cohort iteration
(``_cohort_step``) runs the step's two phases per candidate around ONE
reward call: each candidate draws its ``Draws`` from its own generator, as
its independent run would; ``netes._perturb`` makes its candidates; one
``reward_fn`` call rolls out the cohort's S·2N episodes; ``netes._finish``
shapes each candidate's own 2N returns and runs its Eq. 3 kernel on its
own contiguous (N, P) operands and list or adjacency. On the CPU a round
equals S independent ``netes.run``/``run_scheduled`` calls bit for bit.

**Streams.** The reference folds the candidate id into a threefry key; the
port seeds a torch generator per candidate with ``_stream_seed(sc.seed,
cid)``, and the round's eval draws come from one seeded with
``_stream_seed(sc.seed + 999, cid, rnd)``. A round's scores reach the host
in one ``obs.cuda_watch.device_get``.

**Checkpoints.** With ``sc.checkpoint_dir`` every round saves the
survivors' NetES, schedule and channel states (``checkpoint.io``, the
reference's keys, generators as their state) and a rerun resumes after the
last round on disk. The port's checkpoints are its own: a reference search
checkpoint holds threefry keys where the port holds generators, and does
not restore here.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import checkpoint
from .._device import resolve_device
from ..comm.channel import Channel, compile_channel
from ..core import netes, topology_repr, topology_sched
from ..core.netes import Draws, NetESConfig, NetESState
from ..core.topology_sched import TopologySchedule
from ..envs import resolve_task
from ..obs.cuda_watch import device_get
from .candidates import CandidateSpec, make_grid, seed_pool


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Everything a tournament needs; serializable and deterministic: two
    searches with equal configs on one device give identical results."""

    n_agents: int = 64
    families: Tuple[str, ...] = ("erdos_renyi", "small_world",
                                 "scale_free", "fully_connected")
    densities: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.33)
    seeds: Tuple[int, ...] = (0, 1)
    schedules: Tuple[Optional[str], ...] = (None,)
    channels: Tuple[Optional[str], ...] = (None,)   # DESIGN.md §11
    pool_size: int = 12            # after theory-prior pruning
    round_iters: int = 16          # round-0 training iterations
    widen: bool = True             # double the per-round budget (halving's
    #                                freed compute goes to the survivors)
    eval_episodes: int = 1         # noise-free eval episodes per score
    seed: int = 0
    representation: str = "auto"   # auto | dense | sparse (per candidate)
    keep_families: Tuple[str, ...] = ("fully_connected",)
    checkpoint_dir: Optional[str] = None
    netes: NetESConfig = dataclasses.field(default_factory=NetESConfig)


@dataclasses.dataclass
class SearchResult:
    """The tournament's outcome, for ``TrainConfig.from_search_result``."""

    winner: CandidateSpec
    score: float                       # the winner's last eval score
    control_scores: Dict[str, float]   # control family -> last eval score
    pool: List[CandidateSpec]          # the pruned pool (prior order)
    history: List[dict]                # per-round scores and survivors
    wall_s: float
    n_agents: int

    @property
    def topology(self):
        return self.winner.topo

    @property
    def schedule(self):
        return self.winner.sched

    @property
    def channel(self):
        return self.winner.chan

    def to_json(self) -> dict:
        return {
            "winner": self.winner.label(),
            "topology": dataclasses.asdict(self.topology),
            "schedule": (dataclasses.asdict(self.schedule)
                         if self.schedule else None),
            "channel": (self.channel.label() if self.channel else None),
            "score": self.score,
            "control_scores": self.control_scores,
            "pool": [c.label() for c in self.pool],
            "history": self.history,
            "wall_s": self.wall_s,
            "n_agents": self.n_agents,
        }


# ---------------------------------------------------------------------------
# per-candidate plans and cohort keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    """How one candidate runs: its cohort key, and either its static
    ``Topology`` or its compiled ``TopologySchedule``, with its compiled
    ``Channel`` (or None). A ``Channel`` holds no tensor, so it keys the
    cohort as it is."""

    cohort: tuple
    topo: Optional[topology_repr.Topology] = None
    schedule: Optional[TopologySchedule] = None
    channel: Optional[Channel] = None


def _plan_candidate(cand: CandidateSpec, representation: str,
                    device: Union[str, torch.device] = "cuda") -> _Plan:
    channel = (compile_channel(cand.chan, cand.topo.n_agents)
               if cand.channeled else None)
    if not cand.scheduled:
        adj = cand.topo.build()
        rep = representation
        if rep == "auto":
            # without the channel, as the reference: a fused channel would
            # raise the sparse cutoff and change the cohorts
            rep = topology_repr.select_representation(adj)
            if rep == "circulant":
                rep = "sparse"   # static offsets cannot vary in a cohort
        if rep not in ("dense", "sparse"):
            raise ValueError(
                f"tournaments batch dense or sparse candidates, not "
                f"{rep!r} (circulant offsets are jit-static aux)")
        return _Plan(cohort=("static", rep, channel),
                     topo=topology_repr.from_dense(adj, rep, device=device),
                     channel=channel)
    rep = representation
    if cand.sched.kind == "rotate_circulant":
        rep = "auto"             # compiles to a rotating circulant
    schedule = topology_sched.compile_schedule(cand.sched, cand.topo, rep)
    # What ``TopologySchedule.advance`` reads must agree across a cohort
    # (the cohort's first schedule advances them all); the base seed and
    # family are read at init only and may differ.
    base_p = (round(float(schedule.base.p), 9)
              if schedule.spec.kind in ("anneal_density", "resample_er")
              else None)
    key = ("sched", schedule.spec, schedule.representation, schedule.n,
           schedule.base_offsets, base_p, channel)
    return _Plan(cohort=key, schedule=schedule, channel=channel)


def _make_plans(pool: Sequence[CandidateSpec], representation: str,
                device: Union[str, torch.device] = "cuda") -> List[_Plan]:
    plans = [_plan_candidate(c, representation, device) for c in pool]
    # One neighbor-list pad per scheduled cohort: the cohort's largest
    # k_max (static sparse candidates are widened by topology_repr.stack).
    by_cohort: Dict[tuple, List[int]] = {}
    for i, p in enumerate(plans):
        if p.schedule is not None and p.schedule.k_max:
            by_cohort.setdefault(p.cohort, []).append(i)
    for idxs in by_cohort.values():
        k = max(plans[i].schedule.k_max for i in idxs)
        for i in idxs:
            plans[i].schedule = dataclasses.replace(plans[i].schedule,
                                                    k_max=k)
    return plans


def _stream_seed(base: int, *parts: int) -> int:
    """The seed of a candidate's generator: ``base`` followed by each part
    in 20 bits of its own (mod 2⁶⁴), so two candidates, or two rounds of
    one, never share a stream while their ids stay below 2²⁰. Stands where
    the reference folds the ids into a threefry key."""
    seed = base
    for part in parts:
        if not 0 <= part < 1 << 20:
            raise ValueError(f"stream id {part} out of [0, 2**20)")
        seed = (seed << 20) | part
    return seed % (1 << 64)


# ---------------------------------------------------------------------------
# the batched cohort round
# ---------------------------------------------------------------------------

def _cohort_step(states: List[NetESState], topos, reward_fn,
                 cfg: NetESConfig, channel: Optional[Channel] = None,
                 cstates: Optional[list] = None,
                 draws: Optional[Sequence[Draws]] = None,
                 schedule: Optional[TopologySchedule] = None,
                 sstates: Optional[list] = None):
    """One NetES iteration of every candidate of a cohort, with ONE
    ``reward_fn`` call for all their candidates: ``netes_step`` per
    candidate, bit for bit, but for the batch its rollout runs in.

    ``topos`` holds each candidate's topology; with ``schedule`` it is
    None and each candidate steps on its ``sstates[i].topo``, then
    advances. ``draws[i]`` replaces candidate i's draws (else drawn from
    its state's generator). Returns the new ``(states, sstates,
    cstates)``; no host sync."""
    s = len(states)
    if schedule is not None:
        topos = [ss.topo for ss in sstates]
    if draws is None:
        draws = [netes.draw(st, reward_fn, *st.thetas.shape)
                 for st in states]
    parts = [netes._perturb(st, cfg, d)
             for st, d in zip(states, draws, strict=True)]
    candidates = torch.cat([c for c, _ in parts])
    evals = (None if parts[0][1] is None
             else torch.cat([e for _, e in parts]))
    del parts
    rewards = reward_fn(candidates, evals)
    m = candidates.shape[0] // s
    new_states, new_cs, new_ss = [], [], []
    for i in range(s):
        rows = slice(i * m, (i + 1) * m)
        state, cs, _ = netes._finish(
            states[i], topos[i], rewards[rows], candidates[rows], draws[i],
            cfg, channel, None if cstates is None else cstates[i], None,
            None)
        new_states.append(state)
        new_cs.append(cs)
        if schedule is not None:
            new_ss.append(schedule.advance(sstates[i], draws[i].schedule_u))
    return (new_states, new_ss if schedule is not None else None,
            new_cs if channel is not None else None)


def _eval_scores(states: List[NetESState], reward_fn, episodes: int,
                 generators: Optional[Sequence[torch.Generator]] = None,
                 evals: Optional[Sequence] = None) -> torch.Tensor:
    """(S,) noise-free scores on the device: each candidate's ``best_theta``
    rewarded over ``episodes`` eval draws (from ``generators[i]``, or
    ``evals[i]`` as given), every candidate in one ``reward_fn`` call, the
    mean over each candidate's episodes."""
    params = torch.stack([st.best_theta for st in states])
    if episodes > 1:
        params = params.repeat_interleave(episodes, dim=0)
    if evals is None:
        evals = [reward_fn.draw(g, episodes) for g in generators]
    ev = None if evals[0] is None else torch.cat(list(evals))
    return reward_fn(params, ev).reshape(len(states), episodes).mean(dim=1)


def _round(states: List[NetESState], topos, reward_fn, cfg: NetESConfig,
           num_iters: int, eval_episodes: int,
           eval_generators: Optional[Sequence[torch.Generator]] = None, *,
           channel: Optional[Channel] = None, cstates: Optional[list] = None,
           schedule: Optional[TopologySchedule] = None,
           sstates: Optional[list] = None,
           draws: Optional[Sequence[Sequence[Draws]]] = None,
           eval_evals: Optional[Sequence] = None):
    """One round of a cohort: ``num_iters`` cohort steps, then the scores.
    The counterpart of the reference's ``_round_static`` (``topos``) and
    ``_round_scheduled`` (``schedule`` and ``sstates``). ``draws[i][it]``
    replaces candidate i's draws of iteration ``it`` and ``eval_evals[i]``
    its eval draws. Returns ``(states, sstates, cstates, scores (S,))``,
    the scores on the device."""
    for it in range(num_iters):
        states, sstates, cstates = _cohort_step(
            states, topos, reward_fn, cfg, channel, cstates,
            None if draws is None else [d[it] for d in draws], schedule,
            sstates)
    scores = _eval_scores(states, reward_fn, eval_episodes,
                          eval_generators, eval_evals)
    return states, sstates, cstates, scores


# ---------------------------------------------------------------------------
# the tournament
# ---------------------------------------------------------------------------

def _run_round(alive: List[int], plans: List[_Plan], states: dict,
               sstates: dict, cstates: dict, rnd: int, sc: SearchConfig,
               reward_fn, iters: int, episodes: int,
               device: torch.device) -> Dict[int, float]:
    """Train and score every surviving candidate, one cohort round per
    cohort. Updates ``states``/``sstates``/``cstates`` in place; returns
    the scores, drained to the host in one transfer (a non-finite score
    becomes −inf)."""
    groups: Dict[tuple, List[int]] = {}
    for cid in alive:
        groups.setdefault(plans[cid].cohort, []).append(cid)
    pending = []
    for key, cids in groups.items():
        plan = plans[cids[0]]
        gens = [torch.Generator(device=device).manual_seed(
            _stream_seed(sc.seed + 999, c, rnd)) for c in cids]
        topos = (topology_repr.unstack(topology_repr.stack(
            [plans[c].topo for c in cids])) if key[0] == "static" else None)
        new_states, new_ss, new_cs, vec = _round(
            [states[c] for c in cids], topos, reward_fn, sc.netes, iters,
            episodes, gens, channel=plan.channel,
            cstates=(None if plan.channel is None
                     else [cstates[c] for c in cids]),
            schedule=plan.schedule,
            sstates=(None if plan.schedule is None
                     else [sstates[c] for c in cids]))
        for i, c in enumerate(cids):
            states[c] = new_states[i]
            if new_ss is not None:
                sstates[c] = new_ss[i]
            if new_cs is not None:
                cstates[c] = new_cs[i]
        pending.append((cids, vec))
    host = device_get([vec for _, vec in pending])
    scores: Dict[int, float] = {}
    for (cids, _), vec in zip(pending, host, strict=True):
        for i, c in enumerate(cids):
            s = float(vec[i])
            scores[c] = s if math.isfinite(s) else -math.inf
    return scores


def run_search(task: str, sc: SearchConfig,
               log: Optional[Callable[[dict], None]] = None, *,
               device: Union[str, torch.device] = "cuda") -> SearchResult:
    """Run the tournament on ``task`` ("landscape:<name>" or an env name)
    on ``device`` and return the winning candidate and the round history.

    Deterministic in ``sc`` (seeded initial states and eval draws, halving
    ties broken by candidate id); with ``sc.checkpoint_dir`` set, every
    completed round is saved and a rerun resumes after the last one on
    disk (a checkpoint of another search raises ``ValueError``).
    """
    t0 = time.time()
    dev = resolve_device(device)
    reward_fn, dim, init_fn, _env, _policy = resolve_task(task)
    pool = seed_pool(
        make_grid(sc.n_agents, sc.families, sc.densities, sc.seeds,
                  sc.schedules, sc.channels),
        sc.pool_size, keep_families=sc.keep_families)
    if not pool:
        raise ValueError("empty candidate pool")
    plans = _make_plans(pool, sc.representation, dev)

    states = {cid: netes.init_state(sc.n_agents, dim,
                                    seed=_stream_seed(sc.seed, cid),
                                    init_fn=init_fn, device=dev)
              for cid in range(len(pool))}
    sstates = {cid: plans[cid].schedule.init(device=dev)
               for cid in range(len(pool))
               if plans[cid].schedule is not None}
    cstates = {cid: plans[cid].channel.init(states[cid].thetas)
               for cid in range(len(pool))
               if plans[cid].channel is not None}

    alive = list(range(len(pool)))
    history: List[dict] = []
    last_scores: Dict[int, float] = {}
    total_rounds = max(1, math.ceil(math.log2(len(pool))))
    start_round = 0

    # ---- round-granular resume (checkpoint/io) --------------------------
    ckpt_dir = pathlib.Path(sc.checkpoint_dir) if sc.checkpoint_dir \
        else None
    fingerprint = _search_fingerprint(task, sc)
    if ckpt_dir is not None and (ckpt_dir / "latest.json").exists():
        meta = json.loads((ckpt_dir / "latest.json").read_text())
        if meta.get("fingerprint") != fingerprint:
            raise ValueError(
                f"checkpoint dir {ckpt_dir} holds a different search "
                f"(task/config mismatch: saved "
                f"{meta.get('fingerprint')!r}, current "
                f"{fingerprint!r}); resuming would silently mix states "
                "across searches — use a fresh --search-checkpoint-dir")
        alive = [int(c) for c in meta["alive"]]
        like = _ckpt_blob(alive, states, sstates, cstates)
        done_round, restored = checkpoint.restore_train_state(ckpt_dir,
                                                              like)
        for c in alive:
            states[c] = restored["netes"][str(c)]
        for c, v in restored.get("sched", {}).items():
            sstates[int(c)] = v
        for c, v in restored.get("chan", {}).items():
            cstates[int(c)] = v
        last_scores = {int(k): v for k, v in meta["scores"].items()}
        history = meta["history"]
        start_round = done_round + 1

    ranked = sorted(alive)
    for rnd in range(start_round, total_rounds):
        iters = sc.round_iters * (2 ** rnd if sc.widen else 1)
        episodes = sc.eval_episodes * (2 ** rnd if sc.widen else 1)
        scores = _run_round(alive, plans, states, sstates, cstates, rnd, sc,
                            reward_fn, iters, episodes, dev)
        last_scores.update(scores)
        ranked = sorted(alive, key=lambda c: (-scores[c], c))
        survivors = sorted(ranked[:max(1, (len(alive) + 1) // 2)])
        history.append({
            "round": rnd, "iters": iters,
            "scores": {pool[c].label(): scores[c] for c in alive},
            "survivors": [pool[c].label() for c in survivors]})
        if log:
            log(history[-1])
        alive = survivors
        if ckpt_dir is not None:
            checkpoint.save_train_state(
                ckpt_dir, rnd, _ckpt_blob(alive, states, sstates, cstates),
                extra={"task": task,
                       "fingerprint": fingerprint,
                       "alive": alive,
                       "scores": {str(k): v
                                  for k, v in last_scores.items()},
                       "history": history})

    winner = ranked[0]
    controls = {pool[c].topo.family: last_scores[c]
                for c in range(len(pool))
                if pool[c].topo.family in sc.keep_families
                and c in last_scores}
    return SearchResult(
        winner=pool[winner], score=last_scores[winner],
        control_scores=controls, pool=pool, history=history,
        wall_s=time.time() - t0, n_agents=sc.n_agents)


def _search_fingerprint(task: str, sc: SearchConfig) -> str:
    """The identity of a search for resume validation: everything that
    shapes the pool, the candidate streams or the round schedule. Resuming
    a checkpoint written under another (task, config) would mix states
    across searches. ``checkpoint_dir`` itself is left out: moving or
    copying a dir is a supported resume."""
    d = dataclasses.asdict(sc)
    d.pop("checkpoint_dir")
    return json.dumps({"task": task, **d}, sort_keys=True, default=str)


def _ckpt_blob(alive: List[int], states: dict, sstates: dict,
               cstates: dict) -> dict:
    blob = {"netes": {str(c): states[c] for c in alive}}
    sched = {str(c): sstates[c] for c in alive if c in sstates}
    if sched:
        blob["sched"] = sched
    chan = {str(c): cstates[c] for c in alive if c in cstates}
    if chan:
        blob["chan"] = chan
    return blob
