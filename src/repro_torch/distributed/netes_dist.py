"""NetES over LM agents: the port of ``repro.distributed.netes_dist``'s
replica and consensus train steps and its serve steps, on one device.

``make_replica_train_step`` is paper-faithful NetES over a population of
N agents, each a whole replica of a registry model: the parameters are
the port's tree (``models.transformer``) with a leading agent axis on
every leaf. Agent i's reward is the negated ``transformer.loss_fn`` of
θ_i ± σε_i on its own batch, and the update is Eq. 3 with mirrored
sampling (paper §5.2 mod (2)): with shaped rewards s± of θ_i ± σε_i,

    u_j = α/(Nσ²) Σ_i a_ji [ (s⁺_i + s⁻_i)(θ_i − θ_j) + (s⁺_i − s⁻_i) σ ε_i ].

**Memory.** The agents are evaluated one after another, so one perturbed
replica is alive at a time. The update walks every leaf in column slabs
of its (N, P) view, ``SLAB_COLUMNS`` columns at a time: the slab's θ and
regenerated ε go through the hand-written Eq. 3 kernels (dense →
``netes_mixing``; sparse → ``netes_sparse_mixing``; a sparse wire payload
→ ``fused_neighbor_sum``; the broadcast of a fused quantizing channel →
``fused_broadcast_select``) with w_θ = s⁺ + s⁻ and w_ε = s⁺ − s⁻, and the
result is written back into θ in place. No second (N, P) leaf is made and
ε is never whole: a population of 40 GB of float32 parameters trains in
80 GB. A circulant graph mixes by the plain roll chain.

**Noise contract (seed replay).** ε of agent a, leaf l, slab s (the
columns [s·W, (s+1)·W) of the leaf's flattened (N, P) view, W =
``SLAB_COLUMNS``) is ``torch.randn`` of the slab's length from a
generator seeded with ``stream_seed(agent_noise_seed(seed, a, step), l,
s)`` (``core.es_utils``), on the device of the tensor it fills. Leaves
are numbered in ``core.tree.flatten`` order (dict keys sorted). The perturbation and the update
regenerate the same bits from the same (seed, step, a, l, s), and W is
part of the contract: the perturbation and the update read the one module
constant, at call time (a test sets it to cut leaves into more slabs). The reference folds threefry keys per (agent, leaf, stacked
layer); the two streams give other numbers, and a comparison injects the
reference's ε through the ``noise`` seam.

**Draws.** Every random input of a step enters through ``StepDraws``:
``noise`` (the ε seam: ``noise(out, agent, leaf, slab, start)`` fills
``out``, the slab of ε starting at column ``start``), ``beta`` (the
broadcast happens iff β < p_b), and with a channel or a schedule the
edge mask and the schedule's uniform (None: their own draws). ``draw``
makes a step's defaults; a test hands the reference's draws in.

``mixing``: ``"seed_replay"`` (default) regenerates each slab's ε for the
update; ``"gather"`` makes a leaf's ε whole first, as the reference's
gather mode moves ε with θ, and with a quantizing channel sends it through
the channel's codec too. Without a channel the two are equal bit for bit.

``make_consensus_train_step`` is the placement for archs whose
per-agent replica does not fit (``launch.specs.CONSENSUS_ARCHS``): one
shared θ, P members evaluated one after another (member i's ε is agent
i's of the contract above), the topology entering through degree weights
only (DESIGN.md §7.4); it holds θ, one replica and a few slabs.

The steps keep everything on the device: no ``.item()``, no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..comm import channel as comm_channel
from ..configs.base import ModelConfig
from ..core import es_utils, topology_repr, wire_format
from ..core.netes import NetESConfig
from ..core.topology_repr import Topology
from ..core.tree import flatten, tree_map
from ..kernels.netes_fused_mixing import (fused_broadcast_select,
                                          fused_neighbor_sum)
from ..kernels.netes_mixing import netes_mixing
from ..kernels.netes_sparse_mixing import netes_sparse_mixing
from ..launch import op_costs
from ..models import transformer
from ..obs.regions import region

# Columns of a leaf's (N, P) view mixed at once: at N = 8 an (N, W)
# float32 operand is 512 MiB, and W stays inside every Eq. 3 kernel's
# column range (the broadcast select's is the smallest, 33.5 M).
SLAB_COLUMNS = 1 << 24
MIXINGS = ("seed_replay", "gather")

# fills ``out`` with ε of (agent, leaf, slab) from column ``start``
NoiseFn = Callable[[torch.Tensor, int, int, int, int], Any]


# ---------------------------------------------------------------------------
# parameter trees with an agent axis
# ---------------------------------------------------------------------------

def agent_params(params: Any, i: int) -> Any:
    """Agent i's parameters: views of row i of every leaf."""
    return tree_map(lambda leaf: leaf[i], params)


def init_population(cfg: ModelConfig, n_agents: int, seed: int = 0, *,
                    same_init: bool = True, dtype=torch.float32,
                    device="cuda") -> Any:
    """N agents' parameters with a leading agent axis, built one agent at
    a time (never N + 1 replicas at once). ``same_init`` (the paper's
    Eq. 1/2 regime, the reference's default): every agent starts from
    ``transformer.init_params(cfg, seed)``; else agent i from the seed
    ``stream_seed(seed, i)``."""
    def agent(i):
        return transformer.init_params(
            cfg, seed=seed if same_init else es_utils.stream_seed(seed, i),
            dtype=dtype, device=device)

    p = agent(0)
    pop = tree_map(lambda leaf: torch.empty((n_agents,) + leaf.shape,
                                            dtype=leaf.dtype,
                                            device=leaf.device), p)
    for i in range(n_agents):
        if i and not same_init:
            p = agent(i)
        tree_map(lambda dst, src: dst[i].copy_(src), pop, p)
    return pop


# ---------------------------------------------------------------------------
# on a DeviceMesh (DTensor arguments: launch.specs.lower_pair's traces)
# ---------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This device's piece: a DTensor's local shard (writing it writes the
    DTensor), a plain tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole value on this device: a DTensor gathered (and reduced)
    to every device, a plain tensor itself."""
    return t.full_tensor() if _is_dtensor(t) else t


def _data_layout(mesh, dim: int) -> list:
    from torch.distributed.tensor import Replicate, Shard

    from .sharding import MODEL_AXIS
    return [Replicate() if name == MODEL_AXIS else Shard(dim)
            for name in mesh.mesh_dim_names]


def _agent_rows(leaf: torch.Tensor, n: int):
    """A population leaf (N, ...) as an (N, P) tensor of this device's
    columns with every agent's row, and the function that writes an
    updated one back. On a mesh the agent axis is gathered over the data
    axes (Eq. 3 mixes every sender into every receiver), the feature dims
    keep their shards, and the write-back keeps this device's rows."""
    if not _is_dtensor(leaf):
        return leaf.view(n, -1), lambda flat: None
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes

    from .sharding import MODEL_AXIS
    mesh = leaf.device_mesh
    rows = [p if name == MODEL_AXIS else Replicate()
            for p, name in zip(leaf.placements, mesh.mesh_dim_names,
                               strict=True)]
    gathered = leaf.redistribute(mesh, rows).to_local()
    with _disable_current_modes():       # shape arithmetic, no tensor data
        shape, offset = compute_local_shape_and_global_offset(
            leaf.shape, mesh, leaf.placements)
    r0, mine = offset[0], shape[0]

    def write_back(flat):
        _local(leaf).copy_(flat.view(gathered.shape)[r0:r0 + mine])

    return gathered.view(n, -1), write_back


def _agent_rewards_on_mesh(cfg: ModelConfig, params: Any,
                           batch: Dict[str, torch.Tensor], noise: NoiseFn,
                           sigma: float, microbatch: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``agent_rewards`` with the agent axis over the data axes of a
    DeviceMesh: every device evaluates its own agents one after another,
    each agent's parameters and batch DTensors over the "model" sub-mesh
    (its shards of the feature dims); the rewards are gathered to every
    device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from .sharding import MODEL_AXIS
    mesh = flatten(params)[0].device_mesh
    sub = mesh[MODEL_AXIS]
    m = mesh.mesh_dim_names.index(MODEL_AXIS)

    def agent_view(leaf, a):
        pl = leaf.placements[m]
        pl = Shard(pl.dim - 1) if isinstance(pl, Shard) else Replicate()
        full = tuple(leaf.shape[1:])
        strides = [1] * len(full)
        for d in range(len(full) - 2, -1, -1):
            strides[d] = strides[d + 1] * full[d + 1]
        return DTensor.from_local(leaf.to_local()[a], sub, [pl],
                                  run_check=False, shape=full,
                                  stride=tuple(strides))

    n_loc = flatten(params)[0].to_local().shape[0]
    replica = tree_map(lambda leaf: torch.empty_like(agent_view(leaf, 0)),
                       params)
    pairs = op_costs.repeat_map(
        lambda a: _mirrored_rewards(
            cfg, tree_map(lambda leaf: agent_view(leaf, a), params),
            {k: agent_view(v, a) for k, v in batch.items()}, noise, a,
            sigma, replica, microbatch), n_loc)
    layout = _data_layout(mesh, 0)

    def gather(rs):
        mine = torch.stack([_whole(r) for r in rs])
        return DTensor.from_local(mine, mesh, layout,
                                  run_check=False).full_tensor()

    return gather([p for p, _ in pairs]), gather([q for _, q in pairs])


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def slab_seed(seed: int, step: int, agent: int, leaf: int, slab: int) -> int:
    """The seed of ε for (agent, leaf, slab) at ``step`` (the contract in
    the module note)."""
    return es_utils.stream_seed(
        es_utils.agent_noise_seed(seed, agent, step), leaf, slab)


class NoiseStream:
    """The default ε of one step: the module note's contract. ``device``
    (None: the device of the tensor filled) is where the numbers are
    drawn; a CPU stream filling CUDA tensors gives the card the CPU's
    numbers, for a comparison of the two."""

    def __init__(self, seed: int, step: int, device=None):
        self.seed, self.step = seed, step
        self.device = None if device is None else torch.device(device)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def __call__(self, out: torch.Tensor, agent: int, leaf: int, slab: int,
                 start: int) -> None:
        dev = out.device if self.device is None else self.device
        gen = self._gens.get(dev)
        if gen is None:
            gen = self._gens[dev] = torch.Generator(device=dev)
        gen.manual_seed(slab_seed(self.seed, self.step, agent, leaf, slab))
        if dev == out.device:
            es_utils.sample_noise(gen, out.shape, out.dtype, out=out)
        else:
            out.copy_(es_utils.sample_noise(gen, out.shape, out.dtype))


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """Every random input of one replica step (see the module note).
    ``edge_mask``, for a channel with a dropout stage, replaces the
    channel's own mask; ``schedule_u``, for a schedule whose advance
    redraws the graph, replaces the schedule's uniform."""

    noise: NoiseFn
    beta: torch.Tensor
    edge_mask: Optional[torch.Tensor] = None
    schedule_u: Optional[torch.Tensor] = None


def draw(seed: int, step: int, device="cuda") -> StepDraws:
    """Step ``step``'s default draws: ε from ``NoiseStream(seed, step)``,
    β from a generator on ``device`` seeded with ``stream_seed(seed,
    step)``."""
    gen = torch.Generator(device=device).manual_seed(
        es_utils.stream_seed(seed, step))
    return StepDraws(noise=NoiseStream(seed, step),
                     beta=torch.rand((), generator=gen, device=device))


# ---------------------------------------------------------------------------
# the two phases of a step
# ---------------------------------------------------------------------------

def _slabs(p: int):
    """(slab index, start, stop) of a row of ``p`` columns, in slabs of
    ``SLAB_COLUMNS``."""
    cols = SLAB_COLUMNS
    return [(s, c0, min(p, c0 + cols))
            for s, c0 in enumerate(range(0, p, cols))]


def perturb_params(params: Any, noise: NoiseFn, agent: int, sigma: float,
                   sign: float = 1.0, *, out: Any = None) -> Any:
    """θ + sign·σ·ε of one agent's ``params`` (no agent axis), ε of
    ``agent`` by slab from ``noise``; into ``out`` (a tree like
    ``params``) if given. σε is rounded before the add, as the
    reference's ``leaf + sign·σ·normal``."""
    if out is None:
        out = tree_map(torch.empty_like, params)
    for i, (dst, src) in enumerate(zip(flatten(out), flatten(params),
                                       strict=True)):
        d, t = _local(dst).view(-1), _local(src).reshape(-1)
        for s, c0, c1 in _slabs(d.numel()):
            e = d[c0:c1]
            noise(e, agent, i, s, c0)
            e.mul_(sign * sigma).add_(t[c0:c1])
    return out


def _eval_loss(cfg: ModelConfig, theta: Any, abatch: Dict[str, torch.Tensor],
               microbatch: int) -> torch.Tensor:
    """Mean loss over an agent's batch in microbatches, so that the
    activations are one microbatch's."""
    b = abatch["tokens"].shape[0]
    n_mb = max(1, min(microbatch, b))
    if b % n_mb:
        n_mb = 1
    size = b // n_mb
    total = None
    for m in range(n_mb):
        mb = {k: v[m * size:(m + 1) * size] for k, v in abatch.items()}
        loss = transformer.loss_fn(theta, cfg, mb)
        total = loss if total is None else total + loss
    return total / n_mb


def agent_rewards(cfg: ModelConfig, params: Any,
                  batch: Dict[str, torch.Tensor], noise: NoiseFn,
                  sigma: float, *, microbatch: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's first phase: (R⁺, R⁻), each (N,), the negated losses of
    θ_i + σε_i and θ_i − σε_i on agent i's batch (``batch`` leaves (N,
    per_agent, S)). One perturbed replica is made, filled with θ_i + σε_i
    and then turned into 2θ_i − (θ_i + σε_i), the reference's θ − σε."""
    if _is_dtensor(flatten(params)[0]):
        return _agent_rewards_on_mesh(cfg, params, batch, noise, sigma,
                                      microbatch)
    n = flatten(params)[0].shape[0]
    replica = tree_map(lambda leaf: torch.empty_like(leaf[0]), params)
    pairs = op_costs.repeat_map(
        lambda a: _mirrored_rewards(cfg, agent_params(params, a),
                                    {k: v[a] for k, v in batch.items()},
                                    noise, a, sigma, replica, microbatch), n)
    return (torch.stack([p for p, _ in pairs]),
            torch.stack([m for _, m in pairs]))


def _mirrored_rewards(cfg: ModelConfig, theta: Any,
                      batch: Dict[str, torch.Tensor], noise: NoiseFn,
                      agent: int, sigma: float, replica: Any,
                      microbatch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R⁺, R⁻) of one agent: the negated losses of θ + σε and of
    2θ − (θ + σε), the reference's θ − σε, both made in ``replica``."""
    with region("consensus.perturb"):
        perturb_params(theta, noise, agent, sigma, out=replica)
    with region("consensus.forward"):
        r_pos = -_eval_loss(cfg, replica, batch, microbatch)
    with region("consensus.perturb"):
        tree_map(lambda p, t: p.mul_(-1.0).add_(t, alpha=2.0), replica,
                 theta)
    with region("consensus.forward"):
        return r_pos, -_eval_loss(cfg, replica, batch, microbatch)


class _Mixer:
    """Eq. 3's neighbor term on one slab, by representation, before the
    α/(Nσ²) scale:

        Σ_i a_ji em_ji (w_θi x_i + σ w_εi e_i) − (Σ_i a_ji em_ji w_θi) θ_j

    with x the θ payload the receivers got (θ itself, a fake-quantized
    slab, or a ``WirePayload`` slab) and e the ε payload (ε itself, or in
    gather mode through a quantizing channel its codec's output)."""

    def __init__(self, topo: Topology, w_theta: torch.Tensor,
                 w_eps: torch.Tensor, sigma: float,
                 edge_mask: Optional[torch.Tensor], wt_sum: torch.Tensor,
                 fused: bool):
        self.topo, self.w_theta, self.w_eps = topo, w_theta, w_eps
        self.sigma, self.edge_mask, self.fused = sigma, edge_mask, fused
        self.wt_sum = wt_sum[:, None]
        if topo.kind == "dense":
            self.adj = topo.adj if edge_mask is None else topo.adj * edge_mask
        elif topo.kind == "sparse":
            self.mask = (topo.neighbor_mask if edge_mask is None
                         else topo.neighbor_mask * edge_mask)
            self.zeros = torch.zeros_like(w_theta)

    def _kernel(self, w_theta, x, e):
        if self.topo.kind == "dense":
            return netes_mixing(self.adj, w_theta, self.w_eps, x, e,
                                sigma=self.sigma)
        return netes_sparse_mixing(self.topo.neighbor_idx, self.mask,
                                   w_theta, self.w_eps, x, e,
                                   sigma=self.sigma)

    def _wire_sum(self, coeff, wp: wire_format.WirePayload):
        return fused_neighbor_sum(self.topo.neighbor_idx,
                                  self.topo.neighbor_mask, coeff, wp.codes,
                                  wp.scale, self.edge_mask)

    def __call__(self, theta: torch.Tensor, eps: torch.Tensor, x=None,
                 e=None) -> torch.Tensor:
        if (isinstance(x, wire_format.WirePayload)
                and not (self.fused and self.topo.kind == "sparse")):
            x, e = (wire_format.decode_payload(v)
                    if isinstance(v, wire_format.WirePayload) else v
                    for v in (x, e))
        if isinstance(x, wire_format.WirePayload):
            # the θ term straight from the codes; the ε term from its own
            # codes, or from the sparse kernel with w_θ = 0
            mixed = self._wire_sum(self.w_theta, x)
            if isinstance(e, wire_format.WirePayload):
                mixed = mixed + self.sigma * self._wire_sum(self.w_eps, e)
            else:
                mixed = mixed + self._kernel(self.zeros, theta,
                                             eps if e is None else e)
            return mixed - self.wt_sum * theta
        x = theta if x is None else x
        e = eps if e is None else e
        if self.topo.kind == "circulant":
            return (topology_repr.weighted_neighbor_sum(
                        self.topo, self.w_theta, x, self.edge_mask)
                    + self.sigma * topology_repr.weighted_neighbor_sum(
                        self.topo, self.w_eps, e, self.edge_mask)
                    - self.wt_sum * theta)
        mixed = self._kernel(self.w_theta, x, e)
        # the kernel subtracts wsum·x_j; Eq. 3 subtracts wsum·θ_j
        return mixed if x is theta else mixed + self.wt_sum * (x - theta)


def _payload_slab(leaf_payload, c0: int, c1: int):
    """Columns [c0, c1) of a leaf's (N, P) payload, contiguous."""
    if leaf_payload is None:
        return None
    if isinstance(leaf_payload, wire_format.WirePayload):
        n = leaf_payload.codes.shape[0]
        return wire_format.WirePayload(
            codes=leaf_payload.codes.reshape(n, -1)[:, c0:c1].contiguous(),
            scale=leaf_payload.scale.reshape(n, 1),
            dtype=leaf_payload.dtype)
    n = leaf_payload.shape[0]
    return leaf_payload.reshape(n, -1)[:, c0:c1].contiguous()


def replica_update(params: Any, r_pos: torch.Tensor, r_neg: torch.Tensor,
                   draws: StepDraws, topo: Topology, ncfg: NetESConfig, *,
                   mixing: str = "seed_replay", channel=None, chan_state=None,
                   probe_consensus: bool = False):
    """The step's second phase: fitness shaping, the channel, Eq. 3 and
    the broadcast, written into ``params`` in place, slab by slab.
    Returns ``(metrics, chan_state)``; with ``probe_consensus`` the
    metrics carry ``theta_spread`` and ``update_var`` (Σ over leaves and
    columns of the variance over agents)."""
    n = r_pos.shape[0]
    sigma = ncfg.sigma
    draws = dataclasses.replace(draws, beta=_whole(draws.beta))
    raw = torch.cat([r_pos, r_neg])
    shaped = es_utils.centered_rank(raw)
    s_pos, s_neg = shaped[:n], shaped[n:]
    w_theta, w_eps = s_pos + s_neg, s_pos - s_neg
    leaves = flatten(params)

    edge_mask = info = wire = None
    if channel is not None:
        apply = (channel.apply_wire if channel.wire_quantized
                 else channel.apply)
        payload, edge_mask, chan_state, info = apply(
            chan_state, topo, params, edge_mask=draws.edge_mask)
        # a dropout-only channel passes θ through unchanged
        if channel.transforms_payload:
            wire = flatten(payload)
    wt_sum = topology_repr.weighted_row_sum(topo, w_theta, edge_mask)
    mix = _Mixer(topo, w_theta, w_eps, sigma, edge_mask, wt_sum,
                 channel is not None and channel.fused)
    scale = ncfg.alpha / (n * sigma ** 2)

    # the broadcast candidate: the argmax over both ±ε halves, with the
    # winning sign
    best_flat = torch.argmax(raw)
    best = torch.remainder(best_flat, n).reshape(1)
    best_sigma = ((best_flat < n).to(torch.float32) * 2.0 - 1.0) * sigma
    do_bcast = draws.beta < ncfg.p_broadcast
    uvar = spread = torch.zeros((), dtype=torch.float32,
                                device=r_pos.device)

    for i, leaf in enumerate(leaves):
        flat, write_back = _agent_rows(leaf, n)
        p = flat.shape[1]
        slabs = _slabs(p)
        eps_leaf = eps_wire = None
        if mixing == "gather":
            eps_leaf = torch.empty_like(flat)
            for s, c0, c1 in slabs:
                for a in op_costs.passes(n):
                    draws.noise(eps_leaf[a, c0:c1], a, i, s, c0)
            if wire is not None:
                eps_wire = (channel.encode_wire(eps_leaf, batched=True)
                            if channel.wire_quantized
                            else channel.codec(eps_leaf, batched=True))
        # with a channel the broadcast message is the whole leaf's best
        # perturbed parameters: gathered here, sent after the leaf's mixing
        best_pert = (torch.empty(p, dtype=flat.dtype, device=flat.device)
                     if channel is not None else None)
        for s, c0, c1 in slabs:
            theta = flat[:, c0:c1].contiguous()
            if eps_leaf is None:
                eps = torch.empty_like(theta)
                for a in op_costs.passes(n):
                    draws.noise(eps[a], a, i, s, c0)
            else:
                eps = eps_leaf[:, c0:c1].contiguous()
            mixed = mix(theta, eps,
                        None if wire is None else _payload_slab(wire[i], c0,
                                                                c1),
                        _payload_slab(eps_wire, c0, c1))
            update = es_utils.apply_weight_decay(theta, scale * mixed,
                                                 ncfg.weight_decay)
            new = theta + update
            bp = (theta.index_select(0, best)[0]
                  + best_sigma * eps.index_select(0, best)[0])
            if channel is None:
                new = torch.where(do_bcast, bp[None], new)
                if probe_consensus:
                    spread = spread + new.var(dim=0, correction=0).sum()
            else:
                best_pert[c0:c1] = bp
            if probe_consensus:
                uvar = uvar + update.var(dim=0, correction=0).sum()
            flat[:, c0:c1] = new
        if channel is None:
            write_back(flat)
            continue
        # the broadcast, as received over the lossy wire
        if channel.fused and channel.wire_quantized:
            msg = channel.encode_wire(best_pert, batched=False)
        else:
            msg = channel.codec(best_pert, batched=False)
        for s, c0, c1 in slabs:
            if isinstance(msg, wire_format.WirePayload):
                new = fused_broadcast_select(msg.codes[c0:c1], msg.scale,
                                             do_bcast,
                                             flat[:, c0:c1].contiguous())
            else:
                new = torch.where(do_bcast, msg[None, c0:c1], flat[:, c0:c1])
            if probe_consensus:
                spread = spread + new.var(dim=0, correction=0).sum()
            flat[:, c0:c1] = new
        write_back(flat)

    metrics = {
        "reward_mean": raw.mean(),
        "reward_max": raw.max(),
        "reward_std": raw.std(correction=0),
        "loss_mean": -raw.mean(),
        "broadcast": do_bcast.to(torch.float32),
    }
    if probe_consensus:
        metrics["theta_spread"] = spread
        metrics["update_var"] = uvar
    if channel is not None:
        bcast_msgs = do_bcast.to(torch.float32) * n
        metrics["msgs"] = info["msgs"] + bcast_msgs
        metrics["trigger_frac"] = info["trigger_frac"]
        metrics["drop_frac"] = info["drop_frac"]
        chan_state = dataclasses.replace(chan_state,
                                         msgs=chan_state.msgs + bcast_msgs)
    return metrics, chan_state


# ---------------------------------------------------------------------------
# replica-mode NetES train step
# ---------------------------------------------------------------------------

def make_replica_train_step(cfg: ModelConfig, ncfg: NetESConfig,
                            n_agents: int, mixing: str = "seed_replay",
                            microbatch: int = 4,
                            topology: Optional[Topology] = None,
                            schedule=None, channel=None, probes=None
                            ) -> Callable:
    """Returns ``step(params, adj, batch, draws[, sched_state][,
    chan_state][, metrics_state]) -> (params, metrics[, sched_state'][,
    chan_state'][, metrics_state])``, the reference's order.

    ``params``: the population tree (a leading agent axis N on every
    leaf), updated IN PLACE and returned. ``adj``: an (N, N) adjacency,
    ignored (pass None) when ``topology`` or ``schedule`` is given.
    ``batch``: ``tokens`` and ``labels`` of shape (N, per_agent, S).
    ``draws``: a ``StepDraws`` (``draw(seed, step)`` for the defaults).
    ``microbatch``: an agent's batch is evaluated in this many pieces.

    ``topology`` (a ``core.topology_repr.Topology``) picks the Eq. 3
    kernel by its representation. ``schedule`` (a
    ``core.topology_sched.TopologySchedule``): the step mixes over
    ``sched_state.topo`` and returns the advanced state. ``channel`` (a
    ``comm.channel.Channel``): θ, the payload every agent sends, passes
    through the channel as one message per agent (the wire form when the
    channel is wire-quantized, mixed from the codes by the fused kernel on
    a sparse graph), dropped links leave both the θ and the ε terms (a
    lost message loses the reward that keys the replay), and the broadcast
    goes through the channel's codec (one fused select per slab when
    fused); the metrics gain ``msgs``, ``trigger_frac`` and ``drop_frac``.
    ``probes`` (an ``obs.probes.Probes``): the step records its metrics
    (and the graph) into the ring, in place; the metrics gain
    ``theta_spread`` and ``update_var``. Probes read only: a probed run
    equals the unprobed one bit for bit.
    """
    if mixing not in MIXINGS:
        raise ValueError(f"unknown mixing {mixing!r}; available: {MIXINGS}")

    def step(params, adj, batch, draws: StepDraws, *states):
        want = [s for s, on in (("sched_state", schedule), ("chan_state",
                                                             channel),
                                ("metrics_state", probes)) if on is not None]
        if len(states) != len(want):
            raise TypeError(f"the step takes {want} after the draws, got "
                            f"{len(states)} state arguments")
        given = dict(zip(want, states))
        sstate = given.get("sched_state")
        if sstate is not None:
            topo = sstate.topo
        elif topology is not None:
            topo = topology
        else:
            adj = _whole(adj)
            topo = topology_repr.as_topology(adj, device=adj.device)
        r_pos, r_neg = agent_rewards(cfg, params, batch, draws.noise,
                                     ncfg.sigma, microbatch=microbatch)
        metrics, cstate = replica_update(
            params, r_pos, r_neg, draws, topo, ncfg, mixing=mixing,
            channel=channel, chan_state=given.get("chan_state"),
            probe_consensus=probes is not None)
        out = [params, metrics]
        if schedule is not None:
            out.append(schedule.advance(sstate, u=draws.schedule_u))
        if channel is not None:
            out.append(cstate)
        if probes is not None:
            out.append(probes.record(given["metrics_state"], metrics, topo))
        return tuple(out)

    return step


# ---------------------------------------------------------------------------
# consensus-mode NetES train step (time-multiplexed population)
# ---------------------------------------------------------------------------

def member_rewards(cfg: ModelConfig, params: Any,
                   batch: Dict[str, torch.Tensor], noise: NoiseFn,
                   sigma: float, replica: Any
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The consensus step's first phase: (R⁺, R⁻), each (P,), the negated
    losses of θ + σε_i and 2θ − (θ + σε_i) on member i's microbatch
    (``batch`` leaves (P, microbatch, S)), one shared θ (``params``, no
    agent axis). Each perturbation is made in ``replica`` (a tree like
    ``params``), so one perturbed copy is alive at a time."""
    with region("consensus.members"):
        pairs = op_costs.repeat_map(
            lambda i: _mirrored_rewards(cfg, params,
                                        {k: v[i] for k, v in batch.items()},
                                        noise, i, sigma, replica, 1),
            batch["tokens"].shape[0])
        return (_whole(torch.stack([p for p, _ in pairs])),
                _whole(torch.stack([m for _, m in pairs])))


def consensus_update(params: Any, replica: Any, r_pos: torch.Tensor,
                     r_neg: torch.Tensor, draws: StepDraws,
                     degree: torch.Tensor, ncfg: NetESConfig,
                     channel=None) -> Dict[str, torch.Tensor]:
    """The consensus step's second phase, written into ``params`` in
    place, slab by slab (``replica``, free after the rewards, holds the
    broadcast candidate):

        θ' = θ + α/(Pσ)·Σ_i c_i·(θ + σε_i − θ)/σ − wd·θ,  c_i = w_ε,i·degree_i

    with w_ε = s⁺ − s⁻ of the centered ranks of the 2P rewards, each
    member's term accumulated in member order from its regenerated ε, in
    the reference's expression order. The broadcast candidate, the best
    of the 2P with its sign (θ + σε_b, or 2θ − (θ + σε_b)), is picked in
    the same pass from the old θ by the device's argmax (no host read);
    through a ``channel`` it is sent through the codec as one message a
    leaf (a scale over the whole leaf), and θ' = where(β < p_b,
    candidate, θ') per slab: the fused select when the channel quantizes
    to the wire form. Returns the metrics."""
    with region("consensus.update"):
        n = r_pos.shape[0]
        sigma = ncfg.sigma
        degree = _whole(degree)
        raw = torch.cat([r_pos, r_neg])
        shaped = es_utils.centered_rank(raw)
        coeff = (shaped[:n] - shaped[n:]) * degree
        best_flat = torch.argmax(raw)
        best = torch.remainder(best_flat, n)
        best_pos = best_flat < n
        do_bcast = _whole(draws.beta) < ncfg.p_broadcast
        scale = ncfg.alpha / (n * sigma)
        wd = ncfg.weight_decay
        fused = (channel is not None and channel.fused
                 and channel.wire_quantized)

        for i, (leaf, cand_leaf) in enumerate(zip(flatten(params),
                                                  flatten(replica),
                                                  strict=True)):
            # on a mesh each device updates its own shard
            theta_all = _local(leaf).view(-1)
            cand_all = _local(cand_leaf).view(-1)
            slabs = _slabs(theta_all.numel())
            for s, c0, c1 in slabs:
                t = theta_all[c0:c1]
                cand = cand_all[c0:c1]
                u = torch.zeros_like(t)
                e = torch.empty_like(t)
                for m in op_costs.passes(n):
                    draws.noise(e, m, i, s, c0)
                    e.mul_(sigma).add_(t)                   # θ + σε_m
                    torch.where(best == m, e, cand, out=cand)
                    u.add_(e.sub_(t).mul_(coeff[m]).div_(sigma))
                torch.where(best_pos, cand, t * 2.0 - cand, out=cand)
                new = u.mul_(scale).add_(t).sub_(t * wd)
                if channel is None:
                    new = torch.where(do_bcast, cand, new)
                t.copy_(new)
            if channel is None:
                continue
            # the broadcast as the channel delivers it: one message a leaf
            if fused:
                msg = channel.encode_wire(cand_all, batched=False)
            else:
                msg = channel.codec(cand_all, batched=False)
            for s, c0, c1 in slabs:
                t = theta_all[c0:c1]
                if fused:
                    t.copy_(fused_broadcast_select(msg.codes[c0:c1], msg.scale,
                                                   do_bcast, t[None])[0])
                else:
                    t.copy_(torch.where(do_bcast, msg[c0:c1], t))

        return {"reward_mean": raw.mean(), "reward_max": raw.max(),
                "loss_mean": -raw.mean(),
                "broadcast": do_bcast.to(torch.float32)}


def make_consensus_train_step(cfg: ModelConfig, ncfg: NetESConfig,
                              n_pop: int,
                              topology: Optional[Topology] = None,
                              schedule=None, channel=None) -> Callable:
    """Returns ``step(params, adj, batch, draws[, sched_state][,
    chan_state]) -> (params, metrics[, sched_state'][, chan_state'])``,
    the reference's order: NetES for archs whose per-agent replica does
    not fit (DESIGN.md §2, §7.4).

    ``params``: ONE shared tree (no agent axis), updated IN PLACE and
    returned. ``batch`` leaves: (P, microbatch, S), member i evaluated on
    microbatch i. ``draws``: a ``StepDraws`` (member i's ε is agent i's
    of the noise contract; β; the dropout mask and the schedule's
    uniform). The population is time-multiplexed: the members are
    evaluated one after another in one replica buffer, and the update
    regenerates each member's ε a slab at a time, so the step holds θ,
    one replica and a few slabs.

    The topology enters only through the degree weights, in this order:
    with a ``channel`` whose dropout stage drops links, the live degrees
    ``weighted_row_sum(topo, 1, edge_mask)``; else a ``schedule``'s
    ``sched_state.topo.deg``; else ``topology.deg``; else ``adj``'s
    column sums; each over P. With a ``channel`` the broadcast is the one
    wire payload (it goes through the codec), the metrics gain ``msgs``
    (broadcast·P) and ``trigger_frac`` (1), and the state counts the
    messages. An ``event_triggered`` stage raises ``ValueError``: one
    shared θ has no per-member transmitted payload to trigger against.
    No host sync.
    """
    if channel is not None and channel.event_stage is not None:
        raise ValueError(
            f"channel stage {channel.event_stage.label()!r}: event_triggered "
            "channels need per-agent transmitted payloads; consensus mode "
            "time-multiplexes one shared θ (use replica mode or drop the "
            "event stage)")

    def step(params, adj, batch, draws: StepDraws, *states):
        with region("consensus.step"):
            return _step(params, adj, batch, draws, *states)

    def _step(params, adj, batch, draws, *states):
        want = [s for s, on in (("sched_state", schedule),
                                ("chan_state", channel)) if on is not None]
        if len(states) != len(want):
            raise TypeError(f"the step takes {want} after the draws, got "
                            f"{len(states)} state arguments")
        given = dict(zip(want, states))
        sstate = given.get("sched_state")
        cstate = given.get("chan_state")
        adj = None if adj is None else _whole(adj)
        replica = tree_map(torch.empty_like, params)
        r_pos, r_neg = member_rewards(cfg, params, batch, draws.noise,
                                      ncfg.sigma, replica)
        edge_mask = None
        if channel is not None and channel.dropout_stage is not None:
            topo_c = (sstate.topo if sstate is not None else topology
                      if topology is not None
                      else topology_repr.as_topology(adj, device=adj.device))
            edge_mask = draws.edge_mask
            if edge_mask is None:
                edge_mask = comm_channel.dropout_mask(
                    comm_channel.step_key(cstate.seed, cstate.draws), topo_c,
                    channel.dropout_stage.p)
            cstate = dataclasses.replace(cstate, draws=cstate.draws + 1)
        if edge_mask is not None:
            degree = topology_repr.weighted_row_sum(
                topo_c, torch.ones_like(r_pos), edge_mask) / n_pop
        elif sstate is not None:
            degree = sstate.topo.deg / n_pop
        elif topology is not None:
            degree = topology.deg / n_pop
        else:
            degree = adj.sum(dim=0) / n_pop
        metrics = consensus_update(params, replica, r_pos, r_neg, draws,
                                   degree, ncfg, channel)
        del replica
        out = [params, metrics]
        if schedule is not None:
            out.append(schedule.advance(sstate, u=draws.schedule_u))
        if channel is not None:
            msgs = metrics["broadcast"] * n_pop
            metrics["msgs"] = msgs
            metrics["trigger_frac"] = torch.ones_like(msgs)
            out.append(dataclasses.replace(cstate, msgs=cstate.msgs + msgs))
        return tuple(out)

    return step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill(params, batch) -> logits (B, S, V)``: the full forward."""
    def prefill(params, batch):
        return transformer.forward(params, cfg, batch)

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(params, token, cache, pos) -> (logits, cache)``."""
    def decode(params, token, cache, pos):
        return transformer.decode_step(params, cfg, token, cache, pos)

    return decode


# ---------------------------------------------------------------------------
# contract-linter registry hook (repro_torch.analysis)
# ---------------------------------------------------------------------------

def analysis_entry_points():
    """Contract-linter entry points: both train steps over the
    reference's nano transformer (1 layer, d_model 64, 2 heads of 32) at
    N = 4 — big enough that the run holds the real perturb/evaluate/mix
    structure, small enough to run in well under a second on fake
    tensors."""
    import dataclasses as dc

    from ..analysis.registry import EntryPoint, generator, place
    from ..configs import get_config
    from ..core import topology

    def _nano_cfg():
        return dc.replace(
            get_config("mistral-nemo-12b-smoke"), name="analysis-nano",
            num_layers=1, d_model=64, num_heads=2, num_kv_heads=2,
            head_dim=32, d_ff=128, vocab_size=128)

    def _operands(device, n=4, seq=64):
        cfg = _nano_cfg()
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (n, 1, seq),
                               generator=gen, dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=-1)}
        adj = torch.as_tensor(topology.erdos_renyi(n, p=0.5, seed=0),
                              dtype=torch.float32)
        g = generator(device)
        draws = StepDraws(noise=NoiseStream(0, 0, device=g.device),
                          beta=torch.rand((), generator=g, device=g.device))
        ncfg = NetESConfig(alpha=1e-3, sigma=0.01)
        return (cfg, ncfg, place(adj, device), place(batch, device),
                dc.replace(draws, beta=draws.beta.to(device)))

    def build_replica(device, n=4):
        cfg, ncfg, adj, batch, draws = _operands(device, n)
        step = make_replica_train_step(cfg, ncfg, n, microbatch=1)
        params = place(init_population(cfg, n, device="cpu"), device)
        return step, (params, adj, batch, draws), {}

    def build_consensus(device, n=4):
        cfg, ncfg, adj, batch, draws = _operands(device, n)
        step = make_consensus_train_step(cfg, ncfg, n)
        params = place(transformer.init_params(cfg, device="cpu"), device)
        return step, (params, adj, batch, draws), {}

    return (
        EntryPoint(name="netes_dist.replica_step", build=build_replica,
                   carry=(("params", 0, 0),)),
        EntryPoint(name="netes_dist.consensus_step", build=build_consensus,
                   carry=(("params", 0, 0),)),
    )
