"""End-to-end RL driver of the PyTorch/CUDA port (the paper's experiment):
NetES on an Erdős–Rényi graph against the fully connected baseline, and
the same ER graph over a lossy wire, on pendulum swing-up, with the
paper's evaluation protocol and a checkpoint at the end. ``--search``
lets the topology tournament pick the graph instead (DESIGN.md §10). The
counterpart of ``examples/rl_netes.py``.

  PYTHONPATH=src python examples/rl_netes_torch.py [--iters 60] [--agents 40]
  PYTHONPATH=src python examples/rl_netes_torch.py --task cartpole_swingup \\
      --search
  PYTHONPATH=src python examples/rl_netes_torch.py --trace run.jsonl
"""
import argparse
import dataclasses

from repro_torch.checkpoint import save_train_state
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.train.loop import TrainConfig, train_rl_netes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--agents", type=int, default=40)
    ap.add_argument("--task", default="pendulum")
    ap.add_argument("--search", action="store_true",
                    help="tournament-search the topology first")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="run the first config with on-device probes and a "
                         "JSONL trace at PATH, then print its summary")
    ap.add_argument("--checkpoint-dir", default="experiments/ckpt_rl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    netes_cfg = NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.8)
    eval_every = max(1, args.iters // 6)

    if args.search:
        from repro_torch.search import SearchConfig, run_search
        result = run_search(args.task, SearchConfig(
            n_agents=args.agents,
            families=("erdos_renyi", "fully_connected"),
            densities=(0.1, 0.2, 0.5), seeds=(0, 1), pool_size=6,
            round_iters=10, eval_episodes=4, netes=netes_cfg),
            device=args.device)
        print(f"search winner: {result.winner.label()} "
              f"(fc control: "
              f"{result.control_scores['fully_connected']:.1f})")
        configs = [(result.winner.label(),
                    TrainConfig.from_search_result(
                        result, iters=args.iters, eval_every=eval_every,
                        netes=netes_cfg))]
    else:
        configs = [
            (family, TrainConfig(
                topology=TopologySpec(family=family, n_agents=args.agents,
                                      p=0.5, seed=0),
                iters=args.iters, seed=0, eval_every=eval_every,
                netes=netes_cfg))
            for family in ["erdos_renyi", "fully_connected"]]
        # the same ER graph over a lossy wire (DESIGN.md §11): int8
        # payloads and 10% link faults
        configs.append(("erdos_renyi+q8drop", TrainConfig(
            topology=TopologySpec(family="erdos_renyi", n_agents=args.agents,
                                  p=0.5, seed=0),
            channel="quantize(bits=8)|dropout(p=0.1,seed=0)",
            iters=args.iters, seed=0, eval_every=eval_every,
            netes=netes_cfg)))

    if args.trace:
        # the first run probed (its trajectory unchanged bit for bit) and
        # traced
        name0, tc0 = configs[0]
        configs[0] = (name0, dataclasses.replace(
            tc0, probes="fitness|consensus|graph", trace=args.trace))

    results = {}
    for name, tc in configs:
        hist = train_rl_netes(
            args.task, tc, log=lambda d, name=name: print(f"  {name}: {d}"),
            device=args.device)
        wire = (f" realized_mb={hist['realized_wire_bytes'] / 2 ** 20:.1f}"
                if "realized_wire_bytes" in hist else "")
        print(f"{name:24s} max_eval={hist['max_eval']:.1f} "
              f"({hist['wall_s']:.0f}s){wire}")
        if "probes" in hist:
            p = hist["probes"]
            print(f"  probes[{p['cursor']} samples]: consensus_dist "
                  f"{p['consensus_dist'][0]:.3g} → "
                  f"{p['consensus_dist'][-1]:.3g}, density "
                  f"{p['density'][-1]:.3f}")
        results[name] = hist
    if args.trace:
        from repro_torch.obs import summarize
        print(summarize(args.trace))
    save_train_state(args.checkpoint_dir, args.iters, {"done": 1})
    return results


if __name__ == "__main__":
    main()
