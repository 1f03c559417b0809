"""Recorder cases that need a process group, on the fake one
(``launch.dryrun.start_fake_group``), printed as JSON. Run in a process
of its own (``tests/test_torch_op_costs.py``), so that no process-global
group leaks into other tests:

    PYTHONPATH=src python tests/_torch_op_costs_ranks.py

* ``matmul``: (64, 32) @ (32, 16) over a 2 × 2 ("data", "model") mesh
  under three layouts, beside the same matmul on a world of one: dot
  FLOPs per device, and the collectives of the redistribution to a
  replicated result.
* ``halo``: a 4-rank sparse ER fleet (``fleet_shard.ShardedNetES``, N =
  32, D = 8, p = 0.2), one iteration per rank on fake tensors: the
  collective-permute bytes recorded beside the plan's own
  ``collective_bytes`` figure.
"""
import json

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch.dryrun import start_fake_group
from repro_torch.launch.op_costs import OpCosts


def matmul_cases():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    start_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    layouts = {
        "rows_over_data": ([Shard(0), Replicate()], [Replicate()] * 2),
        "rows_over_both": ([Shard(0), Shard(0)], [Replicate()] * 2),
        "k_over_model": ([Replicate(), Shard(1)], [Replicate(), Shard(0)]),
    }
    out = {}
    with FakeTensorMode():
        a, b = torch.empty(64, 32), torch.empty(32, 16)
        with OpCosts() as one:
            a @ b
        out["world_of_one"] = one.costs()["dot_flops"]
        for name, (pa, pb) in layouts.items():
            da = distribute_tensor(a, mesh, pa)
            db = distribute_tensor(b, mesh, pb)
            with OpCosts() as rec:
                c = da @ db
                c.redistribute(mesh, [Replicate()] * 2)
            costs = rec.costs()
            out[name] = {"dot_flops": costs["dot_flops"],
                         "kinds": {k: costs[f"{k}_count"]
                                   for k in ("all-gather", "all-reduce")},
                         "all-reduce_bytes": costs["all-reduce_bytes"]}
    return out


def halo_cases():
    from repro_torch.analysis.registry import SphereReward
    from repro_torch.core import netes, topology_repr
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.distributed.fleet_shard import ShardedNetES
    from repro_torch.launch.mesh import Mesh
    n, d, world = 32, 8, 4
    topo = topology_repr.from_spec(
        TopologySpec(family="erdos_renyi", n_agents=n, p=0.2, seed=0),
        representation="sparse", device="cpu")
    out = []
    for rank in range(world):
        start_fake_group(world, rank)
        mesh = Mesh(group=dist.group.WORLD, rank=rank, world_size=world,
                    device=torch.device("cpu"))
        eng = ShardedNetES(topo, SphereReward(), NetESConfig(), mesh=mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = netes.init_state(n, d, seed=0, device="cpu")
            with OpCosts() as rec:
                eng.run(state, 1)
        costs = rec.costs()
        out.append({"mode": eng.plan.mode,
                    "recorded": costs["collective-permute_bytes"],
                    "rounds": costs["collective-permute_count"],
                    "plan": eng.collective_bytes(d)["payload_bytes"]})
    return out


def main():
    res = {"matmul": matmul_cases(), "halo": halo_cases()}
    dist.destroy_process_group()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
