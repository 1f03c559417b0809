"""One rank of a torchrun world for the sharded fleet's tests: every case
of ``tests/_torch_shard_cases.py`` over gloo on the CPU, optionally the
permute mixers and a checkpointed (or resumed) training run, saved to
``OUT/rank<r>.pt``. Run as

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/_torch_shard_ranks.py --out DIR [--permute] [--no-cases] \\
        [--train-ckpt DIR] [--train-out FILE]
"""
import argparse
import json
import pathlib
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _torch_shard_cases as cases  # noqa: E402
from repro_torch.comm.channel import compile_channel  # noqa: E402
from repro_torch.distributed import fleet_shard, permute_mixing  # noqa: E402
from repro_torch.train.loop import TrainConfig, train_rl_netes  # noqa: E402

TRAIN = dict(n_agents=cases.N, iters=4, eval_every=2, eval_episodes=2,
             density=0.3, seed=0, netes=cases.CFG)


def permute_outputs(mesh):
    n, rank = mesh.world_size, mesh.rank
    weights, thetas = cases.permute_inputs(n)
    theta = thetas[rank:rank + 1]
    out = {}
    for name, (kind, arg, chan, t) in cases.PERMUTE_CASES.items():
        ch = None if chan is None else compile_channel(chan, n)
        topo = cases.permute_topology(kind, arg, n)
        if kind == "permute":
            mix = permute_mixing.make_permute_mixing(mesh, arg, channel=ch)
        elif kind == "allgather":
            mix = permute_mixing.make_allgather_mixing(mesh, channel=ch)
        elif kind == "sparse":
            mix = permute_mixing.make_sparse_gather_mixing(mesh, topo,
                                                           channel=ch)
        elif kind.startswith("topology"):
            mix = permute_mixing.make_topology_mixing(mesh, topo, channel=ch)
        else:
            rot = permute_mixing.make_rotating_permute_mixing(
                mesh, arg, stride=1, channel=ch)
            out[name] = rot(weights, theta, t)
            continue
        out[name] = mix(weights, theta)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--permute", action="store_true")
    ap.add_argument("--no-cases", action="store_true")
    ap.add_argument("--train-ckpt", default=None)
    ap.add_argument("--train-out", default=None)
    args = ap.parse_args()
    mesh = fleet_shard.build_mesh(None, device="cpu")
    res = {"world_size": mesh.world_size,
           "cases": {} if args.no_cases else
           {name: cases.run(name, mesh) for name in cases.CASES}}
    if args.permute:
        res["permute"] = permute_outputs(mesh)
    if args.train_ckpt is not None:
        tc = TrainConfig(shards=mesh.world_size,
                         checkpoint_dir=args.train_ckpt, **TRAIN)
        hist = train_rl_netes("pendulum", tc, device="cpu")
        if mesh.rank == 0 and args.train_out:
            hist.pop("wall_s")
            pathlib.Path(args.train_out).write_text(json.dumps(hist))
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(res, out / f"rank{mesh.rank}.pt")
    mesh.close()


if __name__ == "__main__":
    main()
