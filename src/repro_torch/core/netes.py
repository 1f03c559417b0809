"""NetES — Networked Evolution Strategies (paper Algorithm 1), one device.

The port of ``repro.core.netes``: one NetES iteration over a stacked
population ``thetas (N, D)``. Update rule (paper Eq. 3):

    θ_j ← θ_j + α/(Nσ²) Σ_i a_ij · R̃_i · ((θ_i + σ ε_i) − θ_j)

with R̃ the shaped returns. Dense and sparse topologies mix through the
hand-written kernels (``kernels/netes_mixing``, ``kernels/netes_sparse_mixing``);
circulant ones through a chain of rolls. With probability p_b per iteration
every agent adopts the best perturbed parameters of the iteration.

Every random draw of a step (ε, the broadcast draw β and the episode reset
states) enters through one seam, ``Draws``: absent, the step draws them from
the state's generator; present, the caller's draws are used as they are —
the tests hand the port the JAX reference's own draws there.

The step keeps everything on the device: no ``.item()``, no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .._device import resolve_device
from ..kernels.netes_mixing import netes_mixing
from ..kernels.netes_sparse_mixing import netes_sparse_mixing
from . import es_utils, topology_repr
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
    shared by the +ε and −ε halves as in the reference.
    """

    eps: torch.Tensor
    beta: torch.Tensor
    evals: Optional[torch.Tensor]


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
                  shaped: torch.Tensor, cfg: NetESConfig) -> torch.Tensor:
    """Eq. 3 on the perturbed parameters θ + σε, by representation:

        u_j = scale_j · Σ_i a_ji R̃_i (θ_i + σ ε_i − θ_j)
            = scale_j · (Σ_i a_ji R̃_i θ_i + σ Σ_i a_ji R̃_i ε_i − (Σ_i a_ji R̃_i) θ_j)

    Dense and sparse run their kernel with w_θ = w_ε = R̃ on the operands
    (θ, ε, σ); circulant runs the roll chain of ``topology_repr``.
    """
    n = thetas.shape[0]
    if topo.kind == "dense":
        mixed = netes_mixing(topo.adj, shaped, shaped, thetas, eps,
                             sigma=cfg.sigma)
    elif topo.kind == "sparse":
        mixed = netes_sparse_mixing(topo.neighbor_idx, topo.neighbor_mask,
                                    shaped, shaped, thetas, eps,
                                    sigma=cfg.sigma)
    elif topo.kind == "circulant":
        perturbed = thetas + cfg.sigma * eps
        mixed = (topology_repr.weighted_neighbor_sum(topo, shaped, perturbed)
                 - topology_repr.weighted_row_sum(topo, shaped)[:, None]
                 * thetas)
    else:
        raise ValueError(f"unknown topology kind {topo.kind!r}")
    if cfg.normalization == "degree":
        scale = cfg.alpha / (topo.deg[:, None] * cfg.sigma ** 2)
    else:
        scale = cfg.alpha / (n * cfg.sigma ** 2)
    return scale * mixed


def netes_step(state: NetESState, topo: Topology, reward_fn,
               cfg: NetESConfig, draws: Optional[Draws] = None
               ) -> Tuple[NetESState, Dict[str, torch.Tensor]]:
    """One NetES iteration (paper Algorithm 1).

    ``reward_fn`` evaluates a batch: ``reward_fn(params (M, D), evals) ->
    (M,)`` with ``evals`` from ``reward_fn.draw(generator, M)``. With
    antithetic sampling both ±ε halves are evaluated in one batch of 2N
    from the same N eval draws, and both compete for the broadcast argmax.
    Returns the new state and a dict of 0-d device tensors.
    """
    n, dim = state.thetas.shape
    if draws is None:
        draws = draw(state, reward_fn, n, dim)
    eps = draws.eps
    if cfg.antithetic:
        candidates = torch.cat([state.thetas + cfg.sigma * eps,
                                state.thetas - cfg.sigma * eps])
        evals = (None if draws.evals is None
                 else torch.cat([draws.evals, draws.evals]))
        rewards = reward_fn(candidates, evals)
        shaped_all = shape_fitness(rewards, cfg.fitness_shaping)
        shaped = shaped_all[:n] - shaped_all[n:]          # antithetic diff
    else:
        candidates = state.thetas + cfg.sigma * eps
        rewards = reward_fn(candidates, draws.evals)
        shaped = shape_fitness(rewards, cfg.fitness_shaping)

    update = mixing_update(topo, state.thetas, eps, shaped, cfg)
    update = es_utils.apply_weight_decay(state.thetas, update,
                                         cfg.weight_decay)
    new_thetas = state.thetas + update

    # broadcast event (exploit): argmax takes the first maximum, as jnp's
    best_idx = torch.argmax(rewards)
    iter_best_theta = candidates[best_idx]
    iter_best_reward = rewards[best_idx]
    do_broadcast = draws.beta < cfg.p_broadcast
    new_thetas = torch.where(do_broadcast, iter_best_theta[None, :],
                             new_thetas)

    better = iter_best_reward > state.best_reward
    new_state = NetESState(
        thetas=new_thetas, generator=state.generator, step=state.step + 1,
        best_reward=torch.where(better, iter_best_reward, state.best_reward),
        best_theta=torch.where(better, iter_best_theta, state.best_theta))
    metrics = {
        "reward_mean": rewards.mean(),
        "reward_max": rewards.max(),
        "reward_min": rewards.min(),
        "reward_std": rewards.std(correction=0),       # fitness dispersion
        "update_var": update.var(dim=0, correction=0).sum(),
        "broadcast": do_broadcast.to(torch.float32),
        "theta_spread": new_thetas.var(dim=0, correction=0).sum(),
        "best_idx": best_idx,
    }
    return new_state, metrics


def run(state: NetESState, topo: Topology, reward_fn, cfg: NetESConfig,
        num_iters: int) -> Tuple[NetESState, Dict[str, torch.Tensor]]:
    """``num_iters`` steps; the metrics come back stacked per iteration,
    still on the device."""
    history = []
    for _ in range(num_iters):
        state, m = netes_step(state, topo, reward_fn, cfg)
        history.append(m)
    if not history:
        return state, {}
    return state, {k: torch.stack([m[k] for m in history])
                   for k in history[0]}
