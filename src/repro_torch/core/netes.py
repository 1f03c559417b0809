"""NetES — Networked Evolution Strategies (paper Algorithm 1), one device.

The port of ``repro.core.netes``: one NetES iteration over a stacked
population ``thetas (N, D)``. Update rule (paper Eq. 3):

    θ_j ← θ_j + α/(Nσ²) Σ_i a_ij · R̃_i · ((θ_i + σ ε_i) − θ_j)

with R̃ the shaped returns. Dense and sparse topologies mix through the
hand-written kernels (``kernels/netes_mixing``, ``kernels/netes_sparse_mixing``);
circulant ones through a chain of rolls. With probability p_b per iteration
every agent adopts the best perturbed parameters of the iteration.

With a lossy ``channel`` (``comm.channel``, DESIGN.md §11–12) the per-source
payloads θ_i + σε_i and the broadcast pass through the channel's stages,
dropped links leave the contraction, and the step returns the advanced
channel state and the realized traffic. A quantizing channel on a sparse
graph mixes straight from the int8 wire codes (``kernels/netes_fused_mixing``),
and its broadcast is one fused select.

Under a topology schedule (``core/topology_sched``, DESIGN.md §9),
``scheduled_step`` steps on the topology in force and then advances the
schedule; ``run_scheduled`` loops it.

A step is two phases around its one reward call: ``_perturb`` makes the
candidates, ``_finish`` does everything after their rewards. The topology
search (``search.tournament``) runs the phases per candidate and rewards a
whole cohort of candidates in one call between them.

Every random draw of a step (ε, the broadcast draw β, the episode reset
states, with a channel the dropout mask, and under a schedule its uniform
redraw) enters through one seam, ``Draws``: absent, the step draws them
from the state's generator (the mask from the channel's own PRF, the
redraw from the schedule's generator); present, the caller's draws are
used as they are — the tests hand the port the JAX reference's own draws
there.

With ``mesh=`` (``distributed.fleet_shard``, DESIGN.md §13) ``run`` and
``run_scheduled`` hand the iterations to the sharded engine: each rank of
the mesh's process group steps its slab of agents, with the same draws
(every rank draws the whole step from its copy of the generator), and the
run returns the gathered state.

``es_step`` is standard ES on one shared θ (paper Eq. 1), the paper's
baseline, with ε from an explicit generator or injected.

Every step function returns ``(state, chan_state, metrics)``, the
scheduled ones ``(state, sched_state, chan_state, metrics)``; without a
channel ``chan_state`` is None. With ``probes`` (``obs.probes``, DESIGN.md
§15) the probe ring ``metrics_state`` joins the return just before the
metrics: ``(state, chan_state, metrics_state, metrics)`` and ``(state,
sched_state, chan_state, metrics_state, metrics)``. Unlike the reference's
functional ring, ``metrics_state`` is updated IN PLACE (a captured CUDA
graph replays into fixed buffers) and the one returned is the one passed
in; ``step_parts`` takes the rest of a return apart. Probes are pure
reads, so a probed run equals the unprobed run bit for bit. The steps keep
everything on the device: no ``.item()``, no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from .._device import resolve_device
from ..kernels.netes_fused_mixing import fused_broadcast_select
from ..kernels.netes_mixing import netes_mixing
from ..kernels.netes_sparse_mixing import netes_sparse_mixing
from ..obs.regions import region
from . import es_utils, topology_repr, wire_format
from .topology_repr import Topology


@dataclasses.dataclass(frozen=True)
class NetESConfig:
    alpha: float = 0.01            # learning rate α
    sigma: float = 0.02            # noise std σ
    p_broadcast: float = 0.8       # paper's global broadcast probability
    weight_decay: float = 0.005
    fitness_shaping: str = "centered_rank"   # centered_rank | normalize | none
    antithetic: bool = True
    # Eq. 3 divides by N for every agent (main text); "degree" uses the
    # proof's per-agent 1/|A_i| (Appendix Eq. 9).
    normalization: str = "global"  # global (1/N) | degree (1/|A_i|)


@dataclasses.dataclass
class NetESState:
    thetas: torch.Tensor              # (N, D) per-agent parameters
    generator: Optional[torch.Generator]   # source of the step's draws
    step: torch.Tensor                # () int32 iteration counter
    best_reward: torch.Tensor         # () f32 running max raw reward
    best_theta: torch.Tensor          # (D,) argmax perturbed params so far


@dataclasses.dataclass(frozen=True)
class Draws:
    """Every random input of one ``netes_step``.

    ``eps (N, D)`` standard normal; ``beta ()`` uniform in [0, 1) (the
    broadcast happens iff β < p_b); ``evals`` what the reward function's
    ``draw`` returns for N agents (episode reset states for an RL task),
    shared by the +ε and −ε halves as in the reference; ``edge_mask``, for
    a channel with a dropout stage, the live-link mask to use in place of
    the channel's own draw (``comm.channel.dropout_mask``);
    ``schedule_u``, for a ``scheduled_step`` whose advance redraws the
    graph, the (N, N) uniform to use in place of the schedule's own draw
    (``TopologySchedule.advance``).
    """

    eps: torch.Tensor
    beta: torch.Tensor
    evals: Optional[torch.Tensor]
    edge_mask: Optional[torch.Tensor] = None
    schedule_u: Optional[torch.Tensor] = None


def init_state(n_agents: int, dim: int, *, seed: int = 0,
               init_fn: Optional[Callable[[torch.Generator, int],
                                          torch.Tensor]] = None,
               same_init: bool = False,
               device: Union[str, torch.device] = "cuda") -> NetESState:
    """Initial population from a generator seeded with ``seed``.

    ``init_fn(generator, count) -> (count, D)``; the default draws
    0.1·N(0, 1). ``same_init=True`` gives every agent one shared θ⁽⁰⁾
    (standard ES); False gives each agent its own draw (paper §2.1).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if init_fn is None:
        def init_fn(g, count):
            return 0.1 * torch.randn(count, dim, generator=g, device=dev)
    if same_init:
        thetas = init_fn(gen, 1).expand(n_agents, dim).contiguous()
    else:
        thetas = init_fn(gen, n_agents)
    return NetESState(
        thetas=thetas, generator=gen,
        step=torch.zeros((), dtype=torch.int32, device=dev),
        best_reward=torch.full((), float("-inf"), device=dev),
        best_theta=thetas[0].clone())


def draw(state: NetESState, reward_fn, n: int, dim: int) -> Draws:
    """One step's draws from the state's generator."""
    g, dev = state.generator, state.thetas.device
    eps = torch.randn(n, dim, generator=g, device=dev,
                      dtype=state.thetas.dtype)
    evals = reward_fn.draw(g, n)
    beta = torch.rand((), generator=g, device=dev)
    return Draws(eps=eps, beta=beta, evals=evals)


def shape_fitness(returns: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "centered_rank":
        return es_utils.centered_rank(returns)
    if kind == "normalize":
        return es_utils.normalize_returns(returns)
    if kind == "none":
        return returns
    raise ValueError(f"unknown fitness shaping {kind!r}")


def mixing_update(topo: Topology, thetas: torch.Tensor, eps: torch.Tensor,
                  shaped: torch.Tensor, cfg: NetESConfig, *,
                  payload=None,
                  edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 3, by representation, on the payloads x_i the receivers see:

        u_j = scale_j · Σ_i a_ji em_ji R̃_i (x_i − θ_j)
            = scale_j · (Σ_i a_ji em_ji R̃_i x_i − (Σ_i a_ji em_ji R̃_i) θ_j)

    ``payload`` None means x = θ + σε: dense and sparse run their kernel
    with w_θ = w_ε = R̃ on the operands (θ, ε, σ). A channel's payload x (a
    tensor) runs the same kernels on (θ, x − θ, 1), which adds one rounding
    of x − θ to each term. A ``WirePayload`` goes through
    ``topology_repr.weighted_neighbor_sum``, which sends a sparse graph to
    the fused wire kernel. ``edge_mask`` (a channel's live-link mask)
    multiplies the adjacency or the neighbor weights before the kernel, so
    a dropped link leaves both the neighbor sum and the row sum. Circulant
    graphs run the plain roll chain of ``topology_repr``.
    """
    n = thetas.shape[0]
    if isinstance(payload, wire_format.WirePayload):
        mixed = (topology_repr.weighted_neighbor_sum(topo, shaped, payload,
                                                     edge_mask)
                 - topology_repr.weighted_row_sum(topo, shaped,
                                                  edge_mask)[:, None]
                 * thetas)
    elif topo.kind in ("dense", "sparse"):
        src, sigma = ((eps, cfg.sigma) if payload is None
                      else (payload - thetas, 1.0))
        if topo.kind == "dense":
            adj = topo.adj if edge_mask is None else topo.adj * edge_mask
            mixed = netes_mixing(adj, shaped, shaped, thetas, src,
                                 sigma=sigma)
        else:
            mask = (topo.neighbor_mask if edge_mask is None
                    else topo.neighbor_mask * edge_mask)
            mixed = netes_sparse_mixing(topo.neighbor_idx, mask, shaped,
                                        shaped, thetas, src, sigma=sigma)
    elif topo.kind == "circulant":
        perturbed = thetas + cfg.sigma * eps if payload is None else payload
        mixed = (topology_repr.weighted_neighbor_sum(topo, shaped, perturbed,
                                                     edge_mask)
                 - topology_repr.weighted_row_sum(topo, shaped,
                                                  edge_mask)[:, None]
                 * thetas)
    else:
        raise ValueError(f"unknown topology kind {topo.kind!r}")
    if cfg.normalization == "degree":
        scale = cfg.alpha / (topo.deg[:, None] * cfg.sigma ** 2)
    else:
        scale = cfg.alpha / (n * cfg.sigma ** 2)
    return scale * mixed


def netes_step(state: NetESState, topo: Topology, reward_fn,
               cfg: NetESConfig, draws: Optional[Draws] = None,
               channel=None, chan_state=None, probes=None,
               metrics_state=None):
    """One NetES iteration (paper Algorithm 1).

    ``reward_fn`` evaluates a batch: ``reward_fn(params (M, D), evals) ->
    (M,)`` with ``evals`` from ``reward_fn.draw(generator, M)``. With
    antithetic sampling both ±ε halves are evaluated in one batch of 2N
    from the same N eval draws, and both compete for the broadcast argmax.
    Returns ``(state, chan_state, metrics)``: the new state, the advanced
    channel state (None without a channel) and a dict of 0-d device
    tensors.

    ``channel`` (a ``comm.channel.Channel``) with its ``chan_state``: the
    payloads θ_i + σε_i pass through the channel (``apply_wire`` when
    ``channel.wire_fused(topo)``, else ``apply``), dropped links leave the
    mixing, and the broadcast payload goes through the channel's codec
    (one ``fused_broadcast_select`` when the channel is fused and
    wire-quantized). The metrics then gain ``msgs`` (this step's realized
    messages, the broadcast's N included), ``trigger_frac`` and
    ``drop_frac``. A lossless channel gives the channel-free step's state
    bit for bit.

    ``probes`` (an ``obs.probes.Probes``) with its ring ``metrics_state``:
    the step's metrics (and, for the ``graph`` stage, ``topo``) are
    recorded into the ring in place, which joins the return before the
    metrics: ``(state, chan_state, metrics_state, metrics)``.
    """
    if probes is not None and metrics_state is None:
        raise ValueError("probes need their ring: pass metrics_state="
                         "probes.init(device)")
    with region("netes.step"):
        if draws is None:
            with region("netes.draw"):
                draws = draw(state, reward_fn, *state.thetas.shape)
        candidates, evals = _perturb(state, cfg, draws)
        with region("netes.rollout"):
            rewards = reward_fn(candidates, evals)
        return _finish(state, topo, rewards, candidates, draws, cfg,
                       channel, chan_state, probes, metrics_state)


def _perturb(state: NetESState, cfg: NetESConfig, draws: Draws):
    """The step's candidates and the evals they are rewarded on: with
    antithetic sampling the ±ε halves (2N, D), both from the same N eval
    draws, else θ + σε (N, D)."""
    eps = draws.eps
    with region("netes.perturb"):
        if not cfg.antithetic:
            return state.thetas + cfg.sigma * eps, draws.evals
        candidates = torch.cat([state.thetas + cfg.sigma * eps,
                                state.thetas - cfg.sigma * eps])
        evals = (None if draws.evals is None
                 else torch.cat([draws.evals, draws.evals]))
        return candidates, evals


def _finish(state: NetESState, topo: Topology, rewards: torch.Tensor,
            candidates: torch.Tensor, draws: Draws, cfg: NetESConfig,
            channel, chan_state, probes, metrics_state):
    """The rest of the step once the candidates' ``rewards`` are in:
    fitness shaping, the channel, Eq. 3, the broadcast, the bookkeeping
    and the metrics. Returns what ``netes_step`` returns."""
    n = state.thetas.shape[0]
    eps = draws.eps
    with region("netes.shape"):
        if cfg.antithetic:
            shaped_all = shape_fitness(rewards, cfg.fitness_shaping)
            shaped = shaped_all[:n] - shaped_all[n:]      # antithetic diff
        else:
            shaped = shape_fitness(rewards, cfg.fitness_shaping)

    with region("netes.mix"):
        payload = edge_mask = info = None
        if channel is not None:
            chan_apply = (channel.apply_wire if channel.wire_fused(topo)
                          else channel.apply)
            wire, edge_mask, chan_state, info = chan_apply(
                chan_state, topo, candidates[:n], edge_mask=draws.edge_mask)
            # a lossless or dropout-only channel passes θ + σε through: the
            # kernels keep reading it as (θ, ε, σ)
            if channel.transforms_payload:
                payload = wire
        update = mixing_update(topo, state.thetas, eps, shaped, cfg,
                               payload=payload, edge_mask=edge_mask)
        update = es_utils.apply_weight_decay(state.thetas, update,
                                             cfg.weight_decay)
        new_thetas = state.thetas + update

    with region("netes.broadcast"):
        # broadcast event (exploit): argmax takes the first maximum, as
        # jnp's; index_select keeps it on the device (indexing with a 0-d
        # tensor reads it on the host). Through a channel the receivers
        # adopt the degraded payload; the best-θ bookkeeping keeps the
        # true one.
        best_idx = torch.argmax(rewards)
        best = best_idx.reshape(1)
        iter_best_theta = candidates.index_select(0, best)[0]
        iter_best_reward = rewards.index_select(0, best)[0]
        do_broadcast = draws.beta < cfg.p_broadcast
        if channel is not None and channel.fused and channel.wire_quantized:
            wp = channel.encode_wire(iter_best_theta, batched=False)
            new_thetas = fused_broadcast_select(wp.codes, wp.scale,
                                                do_broadcast, new_thetas)
        else:
            bcast = (iter_best_theta if channel is None
                     else channel.codec(iter_best_theta, batched=False))
            new_thetas = torch.where(do_broadcast, bcast[None, :],
                                     new_thetas)

        better = iter_best_reward > state.best_reward
        new_state = NetESState(
            thetas=new_thetas, generator=state.generator,
            step=state.step + 1,
            best_reward=torch.where(better, iter_best_reward,
                                    state.best_reward),
            best_theta=torch.where(better, iter_best_theta,
                                   state.best_theta))
        metrics = {
            "reward_mean": rewards.mean(),
            "reward_max": rewards.max(),
            "reward_min": rewards.min(),
            "reward_std": rewards.std(correction=0),   # fitness dispersion
            "update_var": update.var(dim=0, correction=0).sum(),
            "broadcast": do_broadcast.to(torch.float32),
            "theta_spread": new_thetas.var(dim=0, correction=0).sum(),
            "best_idx": best_idx,
        }
        if channel is None:
            chan_state = None
        else:
            # the broadcast is one message fanned out to the population
            bcast_msgs = do_broadcast.to(torch.float32) * n
            chan_state = dataclasses.replace(
                chan_state, msgs=chan_state.msgs + bcast_msgs)
            metrics["msgs"] = info["msgs"] + bcast_msgs
            metrics["trigger_frac"] = info["trigger_frac"]
            metrics["drop_frac"] = info["drop_frac"]
    if probes is None:
        return new_state, chan_state, metrics
    metrics_state = probes.record(metrics_state, metrics, topo)
    return new_state, chan_state, metrics_state, metrics


def step_parts(out: tuple, scheduled: bool = False) -> tuple:
    """What changes between steps in a step's return, probed or not:
    ``(state, chan_state, metrics)``, with ``scheduled`` ``(state,
    sched_state, chan_state, metrics)``. The probe ring is left out: it
    was updated in place."""
    return tuple(out[:3 if scheduled else 2]) + (out[-1],)


def _stack(history) -> Dict[str, torch.Tensor]:
    return ({} if not history else
            {k: torch.stack([m[k] for m in history]) for k in history[0]})


def run(state: NetESState, topo: Topology, reward_fn, cfg: NetESConfig,
        num_iters: int, channel=None, chan_state=None, *, probes=None,
        metrics_state=None, mesh=None):
    """``num_iters`` steps; returns ``(state, chan_state, metrics)`` with the
    metrics stacked per iteration, still on the device; with ``probes``,
    ``(state, chan_state, metrics_state, metrics)``. With ``mesh`` (a
    ``launch.mesh.Mesh``) the steps run sharded over its ranks
    (``fleet_shard.run_sharded``; ``topo`` may be a ``FullyConnected``
    marker there) and return the same."""
    if mesh is not None:
        from ..distributed import fleet_shard
        return fleet_shard.run_sharded(state, topo, reward_fn, cfg,
                                       num_iters, mesh, channel, chan_state,
                                       probes, metrics_state)
    history = []
    for _ in range(num_iters):
        state, chan_state, m = step_parts(netes_step(
            state, topo, reward_fn, cfg, channel=channel,
            chan_state=chan_state, probes=probes,
            metrics_state=metrics_state))
        history.append(m)
    if probes is None:
        return state, chan_state, _stack(history)
    return state, chan_state, metrics_state, _stack(history)


def scheduled_step(state: NetESState, sched_state, reward_fn,
                   cfg: NetESConfig, schedule, draws: Optional[Draws] = None,
                   channel=None, chan_state=None, probes=None,
                   metrics_state=None):
    """One NetES iteration under a ``topology_sched.TopologySchedule``:
    ``netes_step`` on the topology in force (a channel draws its dropout
    mask from it, the ``graph`` probe reads it), then ``schedule.advance``
    with ``draws.schedule_u``. Returns ``(state, sched_state, chan_state,
    metrics)``, with ``probes`` ``(state, sched_state, chan_state,
    metrics_state, metrics)``. No host sync: the schedule's iteration
    counter lives on the host."""
    state, chan_state, metrics = step_parts(netes_step(
        state, sched_state.topo, reward_fn, cfg, draws, channel=channel,
        chan_state=chan_state, probes=probes, metrics_state=metrics_state))
    sched_state = schedule.advance(
        sched_state, None if draws is None else draws.schedule_u)
    if probes is None:
        return state, sched_state, chan_state, metrics
    return state, sched_state, chan_state, metrics_state, metrics


def run_scheduled(state: NetESState, sched_state, reward_fn,
                  cfg: NetESConfig, schedule, num_iters: int, channel=None,
                  chan_state=None, draws: Optional[Sequence[Draws]] = None,
                  *, probes=None, metrics_state=None, mesh=None):
    """``num_iters`` scheduled steps; returns ``(state, sched_state,
    chan_state, metrics)`` with the metrics stacked per iteration, with
    ``probes`` ``(state, sched_state, chan_state, metrics_state,
    metrics)``. ``draws``, if given, holds each iteration's ``Draws``.
    With ``mesh`` the steps run sharded, mixing replicated
    (``fleet_shard.run_sharded_scheduled``), with the same return."""
    if mesh is not None:
        if draws is not None:
            raise ValueError("a sharded run draws its own steps")
        from ..distributed import fleet_shard
        return fleet_shard.run_sharded_scheduled(
            state, sched_state, reward_fn, cfg, schedule, num_iters, mesh,
            channel, chan_state, probes, metrics_state)
    history = []
    for it in range(num_iters):
        state, sched_state, chan_state, m = step_parts(scheduled_step(
            state, sched_state, reward_fn, cfg, schedule,
            None if draws is None else draws[it], channel=channel,
            chan_state=chan_state, probes=probes,
            metrics_state=metrics_state), scheduled=True)
        history.append(m)
    if probes is None:
        return state, sched_state, chan_state, _stack(history)
    return state, sched_state, chan_state, metrics_state, _stack(history)


# ---------------------------------------------------------------------------
# standard ES (paper Eq. 1): the fully connected, shared-θ baseline
# ---------------------------------------------------------------------------

def es_step(theta: torch.Tensor, reward_fn, cfg: NetESConfig, n_agents: int,
            *, generator: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One standard-ES iteration on a single global θ (D,): the paper's
    baseline (the reference's ``core.netes.es_step``).

    ε (``n_agents``, D) comes from ``generator``, or is given: ``eps=`` is
    the seam where a test injects the reference's draw. The reward
    function's evals for ``n_agents`` come from ``generator`` after ε
    (none without one). With antithetic sampling θ ± σε are rewarded in
    one batch of 2N on the same N evals, shaped together, and the halves'
    shaped difference weighs ε; the metrics cover both halves. ``grad =
    Σ shaped·ε / (Nσ)``, ``θ ← θ + α·grad − wd·θ``. Returns ``(θ',
    {"reward_mean", "reward_max"})``, 0-d tensors on θ's device; no host
    sync."""
    if eps is None:
        if generator is None:
            raise ValueError("es_step: pass a generator or eps")
        eps = torch.randn((n_agents,) + tuple(theta.shape),
                          generator=generator, device=theta.device,
                          dtype=theta.dtype)
    evals = None if generator is None else reward_fn.draw(generator,
                                                          n_agents)
    if cfg.antithetic:
        both = torch.cat([theta[None] + cfg.sigma * eps,
                          theta[None] - cfg.sigma * eps])
        rewards = reward_fn(both, None if evals is None
                            else torch.cat([evals, evals]))
        shaped_all = shape_fitness(rewards, cfg.fitness_shaping)
        shaped = shaped_all[:n_agents] - shaped_all[n_agents:]
    else:
        rewards = reward_fn(theta[None] + cfg.sigma * eps, evals)
        shaped = shape_fitness(rewards, cfg.fitness_shaping)
    grad = (shaped[:, None] * eps).sum(dim=0) / (n_agents * cfg.sigma)
    update = es_utils.apply_weight_decay(theta, cfg.alpha * grad,
                                         cfg.weight_decay)
    metrics = {"reward_mean": rewards.mean(), "reward_max": rewards.max()}
    return theta + update, metrics


# ---------------------------------------------------------------------------
# contract-linter registry hook (repro_torch.analysis)
# ---------------------------------------------------------------------------

def analysis_entry_points():
    """Contract-linter entry points: the run drivers this module owns, at
    toy size (N = 8, D = 16), three iterations each. ``build(device)``
    makes fresh operands on ``device`` each call."""
    from ..analysis.registry import (EntryPoint, SphereReward, place,
                                     toy_state, toy_topology)

    # a scheduled step is not captured (ROADMAP §3): its iteration counter
    # is a host int on purpose
    host_t = (("t", "the schedule's iteration counter lives on the host: "
                    "a scheduled step is not captured"),)

    def build_run(device):
        cfg = NetESConfig()
        return (lambda s, a: run(s, a, SphereReward(), cfg, 3),
                (toy_state(device), toy_topology(device)), {})

    def build_run_q8(device):
        from ..comm.channel import compile_channel
        cfg = NetESConfig()
        chan = compile_channel("quantize(bits=8)", 8)
        state = toy_state(device)
        return (lambda s, a, c: run(s, a, SphereReward(), cfg, 3, chan, c),
                (state, toy_topology(device), chan.init(state.thetas)), {})

    def build_run_scheduled(device):
        schedule = toy_schedule()
        cfg = NetESConfig()
        return (lambda s, t: run_scheduled(s, t, SphereReward(), cfg,
                                           schedule, 3),
                (toy_state(device),
                 place(schedule.init(device="cpu"), device)), {})

    return (
        EntryPoint(name="netes.run", build=build_run,
                   carry=(("state", 0, 0),)),
        EntryPoint(name="netes.run.q8", build=build_run_q8,
                   carry=(("state", 0, 0), ("chan", 2, 1))),
        EntryPoint(name="netes.run_scheduled", build=build_run_scheduled,
                   carry=(("state", 0, 0), ("sched", 1, 1)),
                   carry_exempt=host_t),
    )


def toy_schedule():
    """The linter's schedule: ER (N = 8, p = 0.5) redrawn every 2
    iterations."""
    from .topology import TopologySpec
    from .topology_sched import ScheduleSpec, compile_schedule
    base = TopologySpec(family="erdos_renyi", n_agents=8, p=0.5, seed=0)
    return compile_schedule(ScheduleSpec(kind="resample_er", period=2), base)
