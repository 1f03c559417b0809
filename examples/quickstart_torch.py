"""Quickstart of the PyTorch/CUDA port: four communication topologies
racing on a shifted rastrigin landscape through the spec-based API, then
the topology search picking a graph and a run trained on the winner
(DESIGN.md §10). The counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.core import netes, topology, topology_repr
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.envs import make_landscape_reward_fn
from repro_torch.search import SearchConfig, run_search
from repro_torch.train.loop import TrainConfig, train_rl_netes

LANDSCAPE = "rastrigin@2.5"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--agents", type=int, default=32)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--search-iters", type=int, default=10)
    args = ap.parse_args(argv)
    n, dim = args.agents, args.dim
    reward_fn = make_landscape_reward_fn(LANDSCAPE)
    cfg = NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.8)

    def init_fn(generator, count):
        return torch.randn(count, dim, generator=generator,
                           device=generator.device)

    # -- hand-picked topologies through the spec-based API --------------
    print(f"{'topology':20s} {'best reward':>12s}")
    for family in ["erdos_renyi", "scale_free", "small_world",
                   "fully_connected"]:
        spec = TopologySpec(family=family, n_agents=n, p=0.5, seed=0)
        topo = topology_repr.from_spec(spec, device=args.device)
        state = netes.init_state(n, dim, seed=0, init_fn=init_fn,
                                 device=args.device)
        state, _, _ = netes.run(state, topo, reward_fn, cfg, args.iters)
        adj = spec.build()
        print(f"{family:20s} {float(state.best_reward):12.2f}  "
              f"(repr={topo.kind} "
              f"reach={topology.reachability(adj):.3f} "
              f"homog={topology.homogeneity(adj):.3f})")

    # -- or let the tournament pick the graph, then train on it ---------
    task = f"landscape:{LANDSCAPE}"
    result = run_search(
        task, SearchConfig(n_agents=n, densities=(0.1, 0.5), seeds=(0,),
                           pool_size=4, round_iters=args.search_iters,
                           netes=cfg),
        device=args.device)
    print(f"\nsearch winner: {result.winner.label()} "
          f"score={result.score:.2f} "
          f"(fully_connected control: "
          f"{result.control_scores['fully_connected']:.2f})")
    hist = train_rl_netes(
        task, TrainConfig.from_search_result(result, iters=args.iters,
                                             eval_every=args.iters,
                                             netes=cfg),
        device=args.device)
    print(f"trained on the winner: final eval {hist['final_eval']:.2f}")


if __name__ == "__main__":
    main()
