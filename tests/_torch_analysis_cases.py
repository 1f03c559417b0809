"""Seeded violations of the port's op contracts (``repro_torch.analysis.
contracts``), each run as the contract layer runs an entry point, and
printed as JSON: case → the rules of its findings. Run in a process of
its own (``tests/test_torch_analysis_contracts.py``), since the
rank-collective case starts a fake process group:

    PYTHONPATH=src python tests/_torch_analysis_cases.py
"""
import json

import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import check_entry_point
from repro_torch.analysis.registry import EntryPoint
from repro_torch.launch.dryrun import is_fake_group


def _ones(device, *shape):
    return torch.ones(shape, dtype=torch.float32, device=device)


def _state(device):
    return {"theta": _ones(device, 4, 8), "t": 0}


def _case(fn, args_of, **kw):
    return lambda: EntryPoint(name="case", build=lambda device: (
        fn, args_of(device), {}), **kw)


def _rank_dependent(x):
    if dist.get_rank() == 0:       # rank 0 alone issues the all-reduce
        dist.all_reduce(x)
    return x * 2.0


def _same_on_every_rank(x):
    dist.all_reduce(x)
    return x * 2.0


CASES = {
    # no-host-sync
    "item": _case(lambda x: x * float(x.sum().item()),
                  lambda d: (_ones(d, 4),)),
    "copy_to_host": _case(lambda x: x.cpu() + 1.0, lambda d: (_ones(d, 4),)),
    "nonzero": _case(lambda x: torch.nonzero(x), lambda d: (_ones(d, 4),)),
    "device_only": _case(lambda x: torch.where(x > 0, x, -x),
                         lambda d: (_ones(d, 4),)),
    # stable-carry
    "carry_dtype": _case(
        lambda s: ({"theta": s["theta"].double(), "t": s["t"]},),
        lambda d: (_state(d),), carry=(("state", 0, 0),)),
    "carry_host_int": _case(
        lambda s: ({"theta": s["theta"] * 2.0, "t": s["t"] + 1},),
        lambda d: (_state(d),), carry=(("state", 0, 0),)),
    "carry_host_int_exempt": _case(
        lambda s: ({"theta": s["theta"] * 2.0, "t": s["t"] + 1},),
        lambda d: (_state(d),), carry=(("state", 0, 0),),
        carry_exempt=(("t", "a host counter by design"),)),
    # rank-collective-parity, on 2 ranks
    "rank_dependent_collective": _case(
        _rank_dependent, lambda d: (_ones(d, 4),), min_devices=2),
    "same_collectives": _case(
        _same_on_every_rank, lambda d: (_ones(d, 4),), min_devices=2),
    # fused-seam-product and the product ratchet
    "fused_product": _case(
        lambda acc, w, x: torch.addcmul(acc, w, x),
        lambda d: (_ones(d, 4, 8), _ones(d, 4, 1), _ones(d, 4, 8)),
        contracts=("no-host-sync", "fused-seam-product")),
    "rounded_product": _case(
        lambda acc, w, x: acc + w * x,
        lambda d: (_ones(d, 4, 8), _ones(d, 4, 1), _ones(d, 4, 8)),
        contracts=("no-host-sync", "fused-seam-product"), min_products=1),
    "product_dropped": _case(
        lambda acc, w, x: acc + w * x,
        lambda d: (_ones(d, 4, 8), _ones(d, 4, 1), _ones(d, 4, 8)),
        contracts=("no-host-sync", "fused-seam-product"), min_products=2),
}


def main():
    out = {}
    for name, ep in CASES.items():
        out[name] = sorted({f.rule for f in check_entry_point(ep())})
    if is_fake_group():
        dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
