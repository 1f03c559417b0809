"""NetES over a population of policies on an RL task (paper Algorithm 1),
driven through the port's ``core.netes.netes_step`` as its training loop
drives it.

Set-up makes every input from the seed (θ⁽⁰⁾, the adjacency, and the
first steps' ε, reset states and β), builds the topology through the
port's representation selection, and drives the one NetES state through
its first ``len(check_broadcast)`` steps with those draws (the port's
``Draws`` seam): they warm every shape up and are what the reference
follows. The window then steps the same state on the port's own draws,
``drain_chunk`` iterations between host transfers.
"""
from __future__ import annotations

import math
import time

import torch

from portbench import harness, roofline
from portbench.reference import netes_ref

def policy_dims(config) -> list:
    return [config["obs_dim"]] + list(config["hidden"]) + [config["act_dim"]]


def make_theta0(config, n: int, seed: int, device) -> torch.Tensor:
    """Each agent's own θ⁽⁰⁾ (paper §2.1): weights N(0, 2/(din+dout))
    clamped to ±2 standard deviations, biases zero; in one draw."""
    dims = policy_dims(config)
    d = netes_ref.DIM
    raw = torch.randn(n, d, generator=harness.generator(device, seed, 1),
                      device=device).clamp_(-2.0, 2.0)
    at = 0
    for din, dout in zip(dims[:-1], dims[1:], strict=True):
        w = din * dout
        raw[:, at:at + w].mul_(math.sqrt(2.0 / (din + dout)))
        raw[:, at + w:at + w + dout].zero_()
        at += w + dout
    return raw


def make_adjacency(traffic, device) -> torch.Tensor:
    """The (N, N) float32 adjacency with self-loops: G(N, p) (each
    undirected edge present with probability p, drawn on the device from
    the traffic's ``topology_seed``, as a run's graph comes from its own
    topology seed: every run seed then trains on the same graph, and the
    sparse kernel's work does not change with it) or fully connected."""
    n, family = traffic["n_agents"], traffic["topology"]
    if family == "fully_connected":
        return torch.ones(n, n, device=device)
    if family != "erdos_renyi":
        raise ValueError(f"unknown topology family {family!r}")
    u = torch.rand(n, n, generator=harness.generator(
        device, traffic["topology_seed"], 2), device=device)
    adj = torch.triu(u < traffic["p"], diagonal=1)
    del u
    adj = (adj | adj.T).to(torch.float32)
    adj.fill_diagonal_(1.0)
    return adj


def step_draws(seed: int, t: int, n: int, device) -> tuple:
    """ε (N, D) and reset states (N, 2) of checked step t."""
    g = harness.generator(device, seed, 3, t)
    eps = torch.randn(n, netes_ref.DIM, generator=g, device=device)
    u = torch.rand(n, 2, generator=g, device=device)
    resets = torch.stack([-math.pi + 2 * math.pi * u[:, 0],
                          -1.0 + 2.0 * u[:, 1]], dim=1)
    return eps, resets


def netes_cfg(config) -> dict:
    return {k: config["netes"][k] for k in
            ("alpha", "sigma", "p_broadcast", "weight_decay")}


class TimedReward:
    """The task's reward function with CUDA events around each call (when
    ``spans`` is on) and the last returns kept (when ``keep`` is on)."""

    def __init__(self, inner):
        self.inner = inner
        self.spans = False
        self.keep = False
        self.events = []
        self.kept = None

    def draw(self, generator, m):
        return self.inner.draw(generator, m)

    def __call__(self, params, evals):
        if not self.spans or params.device.type != "cuda":
            out = self.inner(params, evals)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.inner(params, evals)
            end.record()
            self.events.append((start, end))
        if self.keep:
            self.kept = out
        return out


class Run:
    """One cell's program under test: set-up, window, traced chunk and
    the outputs of its checked steps."""

    def __init__(self, config, traffic, seed: int, device):
        from repro_torch.core import netes, topology_repr
        from repro_torch.envs import resolve_task

        self.netes = netes
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        n = self.n = traffic["n_agents"]
        inner, dim, _, _, _ = resolve_task(config["task"])
        if dim != netes_ref.DIM:
            raise ValueError(f"the port's policy has {dim} parameters, the "
                             f"configuration {netes_ref.DIM}")
        self.reward = TimedReward(inner)
        c = config["netes"]
        self.ncfg = netes.NetESConfig(
            alpha=c["alpha"], sigma=c["sigma"], p_broadcast=c["p_broadcast"],
            weight_decay=c["weight_decay"],
            fitness_shaping=c["fitness_shaping"],
            antithetic=c["antithetic"], normalization=c["normalization"])
        adj = make_adjacency(traffic, self.device)
        self.edges = int((adj != 0).sum())
        self.topo = topology_repr.from_dense(adj.cpu().numpy(),
                                             representation="auto",
                                             device=self.device)
        del adj
        theta0 = make_theta0(config, n, seed, self.device)
        self.state = netes.init_state(
            n, dim, seed=harness.sub_seed(seed, 4),
            init_fn=lambda g, count: theta0, device=self.device)
        del theta0
        self.outputs = self._checked_steps()

    def _step(self, draws=None):
        state, _, metrics = self.netes.step_parts(self.netes.netes_step(
            self.state, self.topo, self.reward, self.ncfg, draws))
        self.state = state
        return metrics

    def _checked_steps(self) -> dict:
        """The first steps, from the seed's draws; what the reference
        follows."""
        pattern = self.traffic["check_broadcast"]
        betas = harness.check_betas(pattern, self.ncfg.p_broadcast,
                                    self.seed, self.device)
        out = {"theta0": self.state.thetas.clone(), "returns": [],
               "reward_mean": [], "best_idx": [], "thetas": []}
        self.reward.keep = True
        for t, beta in enumerate(betas):
            eps, resets = step_draws(self.seed, t, self.n, self.device)
            draws = self.netes.Draws(
                eps=eps, beta=torch.tensor(beta, device=self.device),
                evals=resets[:, None, :])
            m = self._step(draws)
            out["returns"].append(self.reward.kept)
            out["reward_mean"].append(m["reward_mean"])
            out["best_idx"].append(m["best_idx"])
            # the first step's θ (its update) and the last's (the change)
            out["thetas"].append(self.state.thetas
                                 if t in (0, len(betas) - 1) else None)
        self.reward.keep = False
        self.reward.kept = None
        return out

    def _chunk(self) -> int:
        """``drain_chunk`` iterations on the port's own draws, then one
        host transfer of their metrics; returns how many were not
        finite."""
        from repro_torch.obs import device_get
        pending = []
        for _ in range(self.traffic["drain_chunk"]):
            m = self._step()
            pending.append(torch.stack([m["reward_mean"], m["reward_max"]]))
        host = device_get(torch.stack(pending))
        return int((~torch.isfinite(host)).any(dim=1).sum())

    def window(self, seconds: float, spans: bool) -> dict:
        self.reward.spans = spans
        harness.sync(self.device)
        t0 = time.perf_counter()
        iters = failed = 0
        while True:
            failed += self._chunk()
            iters += self.traffic["drain_chunk"]
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.reward.spans = False
        rollout = [s.elapsed_time(e) for s, e in self.reward.events]
        self.reward.events = []
        return {"metrics": {"rl_iter_ms": elapsed * 1e3 / iters},
                "attempted": iters, "failed": failed,
                "spans": {"rollout_ms": rollout}}

    def traced(self) -> dict:
        """One chunk under the profiler, after the window."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.window"):
                self._chunk()
        return {"prof": prof, "iters": self.traffic["drain_chunk"]}

    def counts(self) -> dict:
        n, d = self.n, netes_ref.DIM
        dense = roofline.eq3_dense(n, d)
        sparse = roofline.eq3_sparse(self.edges, n, d)
        t_dense = roofline.roofline_time(*dense)[0]
        t_sparse = roofline.roofline_time(*sparse)[0]
        eq3 = ((t_dense, dense) if t_dense <= t_sparse
               else (t_sparse, sparse))
        return {"eq3_least_s": eq3[0], "eq3_flops": eq3[1][0],
                "rollout_flops": roofline.rollout_flops(
                    2 * n, self.config["episode_len"],
                    policy_dims(self.config))}

    def release(self) -> dict:
        """Drop the program's state; keep only the checked outputs."""
        out = self.outputs
        self.state = self.topo = self.outputs = None
        return out


def control_outputs(config, traffic, seed: int, device,
                    precision: str = "tf32") -> dict:
    """The control: the reference in TF32 (or ``precision``) put in the
    program's place, from the same inputs, in the program's output
    format."""
    cfg = netes_cfg(config)
    n = traffic["n_agents"]
    adj = make_adjacency(traffic, device)
    thetas = make_theta0(config, n, seed, device)
    betas = harness.check_betas(traffic["check_broadcast"],
                                cfg["p_broadcast"], seed, device)
    out = {"theta0": thetas.clone(), "returns": [], "reward_mean": [],
           "best_idx": [], "thetas": []}
    for t, beta in enumerate(betas):
        eps, resets = step_draws(seed, t, n, device)
        thetas, returns, _, best = netes_ref.netes_iteration(
            thetas, adj, eps, resets, beta, cfg, precision)
        out["returns"].append(returns)
        out["reward_mean"].append(returns.mean())
        out["best_idx"].append(torch.argmax(returns))
        out["thetas"].append(thetas)
    return out


def leaf_norms(x: torch.Tensor) -> list:
    """Norm of each policy leaf's block of a population (N, D), in
    float64."""
    x = x.double()
    return [float(torch.linalg.vector_norm(x[:, a:b]))
            for a, b in netes_ref.leaf_slices()]


def compare(outputs: dict, config, traffic, seed: int, device) -> dict:
    """The numbers compared. The reference follows the checked steps from
    the same inputs in float64 with its own rollouts, which the program's
    returns are held against (``return_q90`` on the first step,
    ``loss_gap`` on every step); from there it
    follows the program's own state where float32 rounding of a chaotic
    rollout reorders candidates: it shapes the fitness from the program's
    returns and adopts the program's broadcast index, so that the update
    (``update_gap``) and θ after the steps (``change_gap``) are held to
    the arithmetic of shaping, Eq. 3, weight decay and the broadcast. The
    broadcast index must be the best by the program's own returns
    (``bcast_regret``, exact)."""
    cfg = netes_cfg(config)
    n = traffic["n_agents"]
    adj = make_adjacency(traffic, device)
    theta0 = make_theta0(config, n, seed, device).double()
    betas = harness.check_betas(traffic["check_broadcast"],
                                cfg["p_broadcast"], seed, device)
    thetas = theta0
    out = {"loss_gap": 0.0, "bcast_regret": 0.0}
    ref_thetas = []
    for t, beta in enumerate(betas):
        eps, resets = step_draws(seed, t, n, device)
        prog_r = outputs["returns"][t].double()
        b = int(outputs["best_idx"][t])
        thetas, ref_r, _, best = netes_ref.netes_iteration(
            thetas, adj, eps, resets, beta, cfg, "f64", pick=lambda _r: b,
            shape_from=prog_r)
        del eps, resets
        rel = (prog_r - ref_r).abs() / ref_r.abs().clamp_min(1e-12)
        out[f"return_q90_t{t}"] = float(torch.quantile(rel, 0.9))
        mean_ref = float(ref_r.mean())
        out["loss_gap"] = max(out["loss_gap"], abs(
            float(outputs["reward_mean"][t]) - mean_ref) / abs(mean_ref))
        if best is not None:
            out["bcast_regret"] = max(out["bcast_regret"], float(
                (prog_r.max() - prog_r[b]) / prog_r[b].abs()))
        ref_thetas.append(thetas)
    # the first step's: its population is every agent's own θ⁽⁰⁾; after a
    # broadcast all 2N candidates perturb one policy, whose rollouts may
    # be the more chaotic (the later steps' q90 swings with that policy)
    out["return_q90"] = out["return_q90_t0"]
    out["update_gap"] = norm_gap(outputs["thetas"][0] - outputs["theta0"],
                                 ref_thetas[0] - theta0)
    out["change_gap"] = norm_gap(outputs["thetas"][-1] - outputs["theta0"],
                                 ref_thetas[-1] - theta0)
    return out


def norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return harness.norm_gaps(leaf_norms(prog), leaf_norms(ref))
