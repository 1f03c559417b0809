"""The sharded fleet's cases (``repro_torch.distributed.fleet_shard``),
built and run the same way by the solo engine in the test process and by
every rank of a torchrun world (``tests/_torch_shard_ranks.py``). Imports
nothing of JAX, so the ranks start quickly."""
import dataclasses

import numpy as np
import torch

from repro_torch.comm.channel import compile_channel
from repro_torch.core import netes, topology_repr
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_sched import ScheduleSpec, compile_schedule
from repro_torch.distributed import fleet_shard
from repro_torch.envs import resolve_task
from repro_torch.obs import compile_probes

N, ITERS = 19, 3          # N = 19: ragged over 2 and 4 ranks (phantom rows)
CFG = NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.5)

# name: (task, representation ("fc": the FullyConnected marker; None: the
# schedule's), density, channel, schedule, probes, NetESConfig changes)
CASES = {
    "sparse": ("pendulum", "sparse", 0.3, None, None,
               "fitness|consensus|graph", {}),
    "dense": ("landscape:rastrigin", "dense", 0.5, None, None, None, {}),
    "full": ("landscape:rastrigin", "fc", 1.0, None, None,
             "fitness|consensus", {}),
    "circulant": ("landscape:rastrigin", "circulant", 0.3, None, None,
                  None, {}),
    "sparse_q8": ("landscape:sphere", "sparse", 0.3, "quantize(bits=8)",
                  None, "all", {}),
    "sparse_q8_unfused": ("landscape:sphere", "sparse", 0.3,
                          "quantize(bits=8)", None, None, {}),
    "topk_degree": ("landscape:rastrigin", "sparse", 0.3, "topk(frac=0.5)",
                    None, None, dict(normalization="degree",
                                     antithetic=False)),
    "channel_a": ("pendulum", "sparse", 0.3,
                  "quantize(bits=8)|dropout(p=0.1,seed=0)", None, "all", {}),
    "dense_dropout": ("landscape:rastrigin", "dense", 0.5,
                      "quantize(bits=8)|dropout(p=0.1,seed=0)", None, None,
                      {}),
    "event": ("landscape:rastrigin", "sparse", 0.3,
              "event_triggered(threshold=0.01)|quantize(bits=4)", None, None,
              {}),
    "resample_er": ("landscape:rastrigin", None, 0.3, None,
                    "resample_er(period=2)", "fitness|graph", {}),
}


def build(name, mesh=None, device="cpu"):
    """(engine, state, chan_state, sched_state, metrics_state) of a case."""
    task, rep, dens, chan, sched, probes, over = CASES[name]
    reward_fn, dim, init_fn, _, _ = resolve_task(task)
    cfg = dataclasses.replace(CFG, **over)
    family = "circulant_erdos_renyi" if rep == "circulant" else "erdos_renyi"
    spec = TopologySpec(family=family, n_agents=N, p=dens, seed=2)
    topo = schedule = sstate = None
    if sched is not None:
        schedule = compile_schedule(ScheduleSpec.parse(sched), spec,
                                    "sparse")
        sstate = schedule.init(device=device)
    elif rep == "fc":
        topo = fleet_shard.FullyConnected(N)
    else:
        topo = topology_repr.from_spec(spec, representation=rep,
                                       device=device)
    ch = None if chan is None else compile_channel(
        chan, N, fused=not name.endswith("unfused"))
    state = netes.init_state(N, dim, seed=0, init_fn=init_fn, device=device)
    pr = None if probes is None else compile_probes(probes, channel=ch,
                                                    dim=dim)
    eng = fleet_shard.ShardedNetES(topo, reward_fn, cfg, mesh=mesh,
                                   channel=ch, schedule=schedule, probes=pr)
    return (eng, state, None if ch is None else ch.init(state.thetas),
            sstate, None if pr is None else pr.init(device))


def run(name, mesh=None, device="cpu", draws=None):
    """What a case's run gives, as a flat dict of tensors: the state (its
    generator's state too), each metric per iteration, the channel's
    message counter and the probe ring."""
    eng, state, cs, ss, ms = build(name, mesh, device)
    out = list(eng.run(state, ITERS, chan_state=cs, sched_state=ss,
                       metrics_state=ms, draws=draws))
    metrics = out.pop()
    st = out[0]
    res = {"thetas": st.thetas, "best_theta": st.best_theta,
           "best_reward": st.best_reward, "step": st.step,
           "generator": st.generator.get_state()}
    res.update({f"metric.{k}": v for k, v in metrics.items()})
    if eng.channel is not None:
        res["msgs_total"] = out[-1 - (eng.probes is not None)].msgs
    if eng.probes is not None:
        res["ring.buf"] = out[-1].buf
        res["ring.cursor"] = out[-1].cursor
    return {k: v.detach().clone() for k, v in res.items()}


# ---- permute mixing (one agent a rank) -------------------------------------

PERMUTE_D = 6


def permute_inputs(n):
    """(weights (n, n), thetas (n, D)) from a seed, the same everywhere."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(n, n)).astype(np.float32)
    th = rng.normal(size=(n, PERMUTE_D)).astype(np.float32)
    return torch.as_tensor(w), torch.as_tensor(th)


# name: (backend, offsets or density, channel, t for the rotating chain)
PERMUTE_CASES = {
    "permute": ("permute", (1,), None, None),
    "permute_q8": ("permute", (1, 2), "quantize(bits=8)", None),
    "allgather": ("allgather", None, None, None),
    "allgather_q8": ("allgather", None, "quantize(bits=8)", None),
    "sparse_gather": ("sparse", 0.5, None, None),
    "topology_circulant": ("topology_circulant", (1,), None, None),
    "topology_sparse": ("topology_sparse", 0.5, "quantize(bits=8)", None),
    "topology_dense": ("topology_dense", 0.5, None, None),
    "rotating_t0": ("rotating", (1,), None, 0),
    "rotating_t1": ("rotating", (1,), None, 1),
    "rotating_t5_q8": ("rotating", (1,), "quantize(bits=8)", 5),
}


def permute_topology(kind, arg, n):
    """The topology a permute case's backend reads (None for the bare
    permute / allgather / rotating backends)."""
    if kind in ("sparse", "topology_sparse", "topology_dense"):
        rep = "dense" if kind == "topology_dense" else "sparse"
        adj = TopologySpec(family="erdos_renyi", n_agents=n, p=arg,
                           seed=1).build()
        return topology_repr.from_dense(adj, rep, device="cpu")
    if kind == "topology_circulant":
        return topology_repr.Topology(
            kind="circulant", n=n, deg=torch.full((n,), 1.0 + 2 * len(arg)),
            offsets=tuple(arg))
    return None
