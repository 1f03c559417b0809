"""One rank of a 2 × 2 torchrun world for the sharding tests: gloo on the
CPU, a ``DeviceMesh`` of dims ("data", "model"), and for each spec of
``SPECS`` the local piece that ``distribute_tensor`` gives this rank under
``sharding.to_placements`` and that ``context.maybe_constrain`` gives it
from a replicated DTensor, beside the slice the spec names, worked out
here from the rank's mesh coordinates. Saved to ``OUT/rank<r>.pt``. Run as

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/_torch_placement_ranks.py --out DIR
"""
import argparse
import os
import pathlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.distributed.context import maybe_constrain, sharding_context
from repro_torch.distributed.sharding import P, to_placements

torch.set_num_threads(1)

MESH = (("data", 2), ("model", 2))
SHAPE = (8, 12, 4)
SPECS = {
    "replicated": P(),
    "rows_data": P("data"),
    "cols_model": P(None, "model"),
    "both": P("data", "model"),
    "swapped": P("model", None, "data"),
    "joint": P(None, ("data", "model")),
}


def named_slice(spec, coords, sizes, shape):
    """The block of a ``shape`` tensor that ``spec`` puts on the device at
    mesh ``coords`` (a dim over several axes: major first)."""
    index = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        if part is None:
            index.append(slice(None))
            continue
        axes = part if isinstance(part, tuple) else (part,)
        block, count = 0, 1
        for a in axes:
            block = block * sizes[a] + coords[a]
            count *= sizes[a]
        step = n // count
        index.append(slice(block * step, (block + 1) * step))
    return tuple(index)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    names = tuple(n for n, _ in MESH)
    sizes = dict(MESH)
    mesh = init_device_mesh("cpu", tuple(sizes[n] for n in names),
                            mesh_dim_names=names)
    coords = dict(zip(names, mesh.get_coordinate(), strict=True))
    x = torch.arange(torch.Size(SHAPE).numel(), dtype=torch.float32)
    x = x.reshape(SHAPE)
    res = {"rank": rank, "coords": coords, "cases": {}}
    for name, spec in SPECS.items():
        want = x[named_slice(spec, coords, sizes, SHAPE)]
        placed = distribute_tensor(x, mesh, to_placements(spec, mesh))
        full = distribute_tensor(x, mesh, [Replicate()] * len(names))
        outside = maybe_constrain(full, "role")
        with sharding_context(mesh, {"role": spec}):
            moved = maybe_constrain(full, "role")
            plain = torch.ones(3)
            res["cases"][name] = {
                "placements": [str(p) for p in to_placements(spec, mesh)],
                "distribute": torch.equal(placed.to_local(), want),
                "constrain": (isinstance(moved, DTensor)
                              and torch.equal(moved.to_local(), want)),
                "plain_unchanged": maybe_constrain(plain, "role") is plain,
                "other_role_unchanged": maybe_constrain(full, "x") is full,
                "outside_unchanged": outside is full,
            }
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
