"""Every pair of ``shape_pairs()``'s smoke analogue (the arch's
``-smoke`` config at the smoke shapes below; the consensus archs' smokes
classified consensus, as their full configs are) traced on a fake 2 × 2
("data", "model") mesh, as ``launch.dryrun`` traces the production
pairs: per pair its mode, whether it traced, the per-device argument
bytes that ``LoweredPair.argument_bytes`` computes from the placements,
and the bytes of the local shards that the DTensors made from them hold.
Printed as JSON. Run in a process of its own
(``tests/test_torch_dryrun.py``), since it starts a fake process group;
``PART COUNT`` takes every COUNT-th pair from the PART-th (the test runs
two parts at once):

    PYTHONPATH=src python tests/_torch_dryrun_ranks.py [PART COUNT]
"""
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import INPUT_SHAPES, shape_pairs
from repro_torch.core.tree import flatten
from repro_torch.launch import specs
from repro_torch.launch.dryrun import start_fake_group

SMOKE_SHAPES = {
    "train_4k": dict(seq_len=64, global_batch=4, kind="train"),
    "prefill_32k": dict(seq_len=64, global_batch=2, kind="prefill"),
    "decode_32k": dict(seq_len=64, global_batch=2, kind="decode"),
    "long_500k": dict(seq_len=128, global_batch=1, kind="decode"),
}


def _local_bytes(args) -> int:
    total = 0
    for leaf in flatten(args):
        if isinstance(leaf, torch.Tensor):
            loc = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += loc.numel() * loc.element_size()
    return total


def main(part: int = 0, count: int = 1):
    INPUT_SHAPES.update(SMOKE_SHAPES)
    specs.CONSENSUS_ARCHS = specs.CONSENSUS_ARCHS + tuple(
        a + "-smoke" for a in specs.CONSENSUS_ARCHS)
    start_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = []
    for arch, shape in shape_pairs()[part::count]:
        res = {"arch": arch + "-smoke", "shape": shape}
        t0 = time.perf_counter()
        try:
            lowered = specs.lower_pair(arch + "-smoke", shape, mesh)
            mode = FakeTensorMode(allow_non_fake_inputs=True)
            args = lowered.fake_args(mode)
            draws = [i for i, k in enumerate(lowered.order) if k == "draws"]
            for i in draws:               # the draws' β, not its noise
                args[i] = args[i].beta
            rec = lowered.trace()
            res.update(ok=True, mode=lowered.pair.mode,
                       argument_bytes=lowered.argument_bytes(),
                       local_shard_bytes=_local_bytes(args),
                       dot_flops=rec.costs()["dot_flops"],
                       kernels=dict(rec.kernels),
                       trace_s=time.perf_counter() - t0)
        except Exception as e:  # reported to the test, which fails on it
            res.update(ok=False, error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        out.append(res)
    dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
