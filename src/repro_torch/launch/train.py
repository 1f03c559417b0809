"""Training launcher of the port: the paper's RL experiments, and NetES
over LM agents.

  python -m repro_torch.launch.train rl --task pendulum \
      --topology erdos_renyi --density 0.1 --agents 1000 --iters 100 \
      [--channel 'quantize(bits=8)|dropout(p=0.1,seed=0)'] \
      [--schedule 'resample_er(period=8)'] [--checkpoint-dir DIR] \
      [--probes 'fitness|consensus|graph'] [--probe-capacity C] \
      [--trace run.trace.jsonl]

With the topology search first (DESIGN.md §10): the tournament picks the
communication graph, then training runs on the winner:

  python -m repro_torch.launch.train rl --task pendulum --agents 1000 \
      --iters 100 --search [--search-pool 6] [--search-iters 10] \
      [--search-schedules 'static,resample_er(period=8)'] \
      [--search-channels 'lossless;quantize(bits=8)'] \
      [--search-checkpoint-dir DIR]

Sharded over the ranks of a process group (DESIGN.md §13; one process a
rank, NCCL on the GPUs, ``--device cpu`` gloo):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train rl \
      --agents 16384 --density 0.0005 --shards 4

NetES over LM agents (each agent a replica of a registry architecture,
trained on the synthetic corpus; ``train.loop.train_lm_netes``):

  python -m repro_torch.launch.train lm --arch gemma3-4b-smoke \
      --agents 8 --iters 20 [--seq-len 128] [--per-agent-batch 1]

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib

from ..configs import get_config
from ..core.netes import NetESConfig
from ..core.topology import TopologySpec
from ..search import SearchConfig, run_search
from ..train.loop import TrainConfig, train_lm_netes, train_rl_netes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["rl", "lm"])
    ap.add_argument("--task", default="pendulum")
    ap.add_argument("--arch", default="gemma3-4b-smoke",
                    help="lm: the registry architecture each agent holds")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="lm: tokens per sequence")
    ap.add_argument("--per-agent-batch", type=int, default=1,
                    help="lm: sequences per agent and iteration")
    ap.add_argument("--topology", default="erdos_renyi")
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--representation", default="auto",
                    choices=["auto", "dense", "sparse", "circulant"],
                    help="physical topology representation")
    ap.add_argument("--topo-seed", type=int, default=0)
    ap.add_argument("--channel", default=None,
                    help="lossy agent-link channel pipeline, e.g. "
                         "'quantize(bits=8)' or 'event_triggered("
                         "threshold=0.01)|quantize(bits=4)|dropout("
                         "p=0.1,seed=0)' (DESIGN.md §11)")
    ap.add_argument("--schedule", default=None,
                    help="time-varying topology, e.g. 'resample_er("
                         "period=8)', 'anneal_density(p_end=0.05,"
                         "horizon=100)' or 'rotate_circulant(stride=3)' "
                         "(DESIGN.md §9)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the train state at every eval point and "
                         "resume from the latest one found here (rl only)")
    ap.add_argument("--probes", default=None,
                    help="on-device telemetry stages, e.g. 'fitness|"
                         "consensus|graph' or 'all' (DESIGN.md §15); "
                         "the drained series lands in history['probes']")
    ap.add_argument("--probe-capacity", type=int, default=0,
                    help="probe ring capacity (0 = default; the ring "
                         "keeps the LAST capacity iterations)")
    ap.add_argument("--trace", default=None,
                    help="write a structured JSONL run trace here (spans "
                         "with wall time, kernel builds and host "
                         "transfers; inspect with 'python -m "
                         "repro_torch.obs summarize')")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard the agent axis over this many ranks (rl "
                         "only; DESIGN.md §13): start one process a rank "
                         "with 'torchrun --nproc-per-node <n>'; 1 runs "
                         "without torchrun")
    ap.add_argument("--agents", type=int, default=32)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--search", action="store_true",
                    help="run the topology-search tournament first and "
                         "train on the winning graph (ignores "
                         "--topology/--density; DESIGN.md §10)")
    ap.add_argument("--search-families",
                    default="erdos_renyi,fully_connected",
                    help="comma-separated candidate families (default: "
                         "the paper's headline ER-vs-FC comparison)")
    ap.add_argument("--search-densities", default="0.1,0.2,0.5",
                    help="comma-separated candidate edge densities")
    ap.add_argument("--search-seeds", default="0,1",
                    help="comma-separated candidate graph seeds")
    ap.add_argument("--search-pool", type=int, default=6,
                    help="tournament pool size after theory-prior pruning")
    ap.add_argument("--search-iters", type=int, default=10,
                    help="round-0 training iterations per candidate "
                         "(doubles every halving round)")
    ap.add_argument("--search-eval-episodes", type=int, default=4,
                    help="noise-free eval episodes averaged per candidate "
                         "score (doubles every halving round)")
    ap.add_argument("--search-schedules", default=None,
                    help="comma-separated schedule candidates, e.g. "
                         "'static,resample_er(period=8)'")
    ap.add_argument("--search-channels", default=None,
                    help="semicolon-separated channel candidates, e.g. "
                         "'lossless;quantize(bits=8);quantize(bits=4)' "
                         "(';' because stages compose with '|') — the "
                         "tournament co-optimizes graph × compression")
    ap.add_argument("--search-checkpoint-dir", default=None,
                    help="save tournament rounds; a rerun resumes after "
                         "the last completed round")
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--p-broadcast", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    netes_cfg = NetESConfig(alpha=args.alpha, sigma=args.sigma,
                            p_broadcast=args.p_broadcast)
    # under torchrun every rank runs this; rank 0 alone prints and writes
    lead = int(os.environ.get("RANK", "0")) == 0

    def log(d):
        print(json.dumps(d), flush=True)

    search_payload = None
    if args.kind == "lm" and (args.search or args.checkpoint_dir
                              or args.shards is not None):
        ap.error("--search, --checkpoint-dir and --shards are rl only")
    if args.search and args.shards is not None:
        ap.error("--search runs on one device; train the winner with "
                 "--shards in a second run")
    if args.search:
        if args.representation == "circulant":
            ap.error("--representation circulant is incompatible with "
                     "--search: tournaments batch dense/sparse payloads "
                     "(static circulant offsets are jit-static aux), and "
                     "the winning graph is not guaranteed circulant")
        if args.schedule is not None:
            ap.error("--schedule conflicts with --search (training uses "
                     "the WINNER's schedule); add scheduled candidates "
                     "via --search-schedules instead")
        if args.channel is not None:
            ap.error("--channel conflicts with --search (training uses "
                     "the WINNER's channel); add channel candidates "
                     "via --search-channels instead")
        sconf = SearchConfig(
            n_agents=args.agents,
            families=tuple(args.search_families.split(",")),
            densities=tuple(float(p)
                            for p in args.search_densities.split(",")),
            seeds=tuple(int(s) for s in args.search_seeds.split(",")),
            schedules=(tuple(args.search_schedules.split(","))
                       if args.search_schedules else (None,)),
            channels=(tuple(args.search_channels.split(";"))
                      if args.search_channels else (None,)),
            pool_size=args.search_pool,
            round_iters=args.search_iters,
            eval_episodes=args.search_eval_episodes,
            seed=args.seed,
            representation=args.representation,
            checkpoint_dir=args.search_checkpoint_dir,
            netes=netes_cfg)
        result = run_search(args.task, sconf, log=log, device=args.device)
        search_payload = result.to_json()
        fc = result.control_scores.get("fully_connected")
        print(f"search winner: {result.winner.label()} "
              f"score={result.score:.3f}"
              + (f" (fully_connected control: {fc:.3f})"
                 if fc is not None else ""), flush=True)
        tc = TrainConfig.from_search_result(
            result, iters=args.iters, seed=args.seed,
            representation=args.representation,
            checkpoint_dir=args.checkpoint_dir, probes=args.probes,
            probe_capacity=args.probe_capacity, trace=args.trace,
            netes=netes_cfg)
    else:
        tc = TrainConfig(
            n_agents=args.agents, iters=args.iters,
            topology=TopologySpec(family=args.topology,
                                  n_agents=args.agents, p=args.density,
                                  seed=args.topo_seed),
            representation=args.representation, channel=args.channel,
            schedule=args.schedule, checkpoint_dir=args.checkpoint_dir,
            probes=args.probes, probe_capacity=args.probe_capacity,
            trace=args.trace, seed=args.seed, netes=netes_cfg,
            shards=args.shards)

    if args.kind == "lm":
        hist = train_lm_netes(get_config(args.arch), tc,
                              seq_len=args.seq_len,
                              per_agent_batch=args.per_agent_batch, log=log,
                              device=args.device)
        print(f"loss: {hist['loss_mean'][0]:.4f} → "
              f"{hist['loss_mean'][-1]:.4f}")
    else:
        hist = train_rl_netes(args.task, tc, log=log, device=args.device)
        if not lead:
            return
        print(f"final eval: {hist['final_eval']}, max eval: "
              f"{hist['max_eval']} ({hist['wall_s']:.1f}s)")
    if "realized_msgs" in hist:
        print(f"realized messages: {hist['realized_msgs']:.0f} "
              f"({hist['realized_wire_bytes']} wire bytes)")
    if "probes" in hist:    # np arrays → JSON-native lists
        hist["probes"] = {k: v.tolist() if hasattr(v, "tolist") else v
                          for k, v in hist["probes"].items()}
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"args": vars(args), "history": hist}
        if search_payload is not None:
            payload["search"] = search_payload
        path.write_text(json.dumps(payload))


if __name__ == "__main__":
    main()
