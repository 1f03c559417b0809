"""Multi-pod dry run: every (architecture × input shape × mesh) pair
traced on fake tensors over a fake process group of 256 (16 × 16) or 512
(2 × 16 × 16) ranks, the port's counterpart of ``repro.launch.dryrun``
(which lowers and compiles for 512 placeholder XLA host devices).

The fake group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``) is started before any mesh is made, as the reference sets
``XLA_FLAGS`` before importing jax: its collectives return at once and
move nothing, and a ``DeviceMesh`` over it gives DTensors their
placements. Each pair's step runs once under ``FakeTensorMode`` and an
``op_costs.OpCosts`` recorder (``launch.specs.lower_pair``): nothing is
allocated and nothing runs, on the CPU.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
      [--out DIR]

Emits one JSON per pair, with the reference's keys where they mean the
same: ``mode``, ``memory`` (per device, ``launch.analysis``),
``op_costs`` (the reference's ``hlo_costs``), ``roofline`` (at the H100's
constants), ``model_flops_per_device``, ``useful_flops_ratio``, and
``trace_s`` (the reference's ``lower_s`` and ``compile_s``),
``peak_by_op`` (the temporaries alive at the peak, by the op that made
each); ``fits`` is
peak per device ≤ the card's memory, and ``argument_bytes_bf16`` the
arguments at the reference's bfloat16 width.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import INPUT_SHAPES, shape_pairs
from . import analysis, specs


_MESHES: dict = {}
# the fake backend for every device a trace's tensors may lie on (meta:
# the contract layer's stand-in for the card, ``analysis.contracts``)
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"


def is_fake_group() -> bool:
    return dist.is_initialized() and dist.get_backend() == FAKE_BACKEND


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """The fake process group of ``world_size`` ranks, as rank ``rank``
    (an existing group of another size or rank is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (is_fake_group() and dist.get_world_size() == world_size
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    _MESHES.clear()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank,
                            world_size=world_size)


def production_device_mesh(multi_pod: bool = False):
    """The reference's production mesh (``launch.mesh``'s named shape) as
    a ``DeviceMesh`` over the fake group."""
    from torch.distributed.device_mesh import init_device_mesh

    from .mesh import make_production_mesh
    named = make_production_mesh(multi_pod=multi_pod)
    n = 1
    for size in named.sizes:
        n *= size
    start_fake_group(n)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = init_device_mesh(
            "cpu", named.sizes, mesh_dim_names=named.axis_names)
    return _MESHES[multi_pod]


def pair_report(lowered, rec, trace_s: float) -> dict:
    """The reference's per-pair keys from a traced pair's recorder."""
    pair = lowered.pair
    costs = rec.costs()
    mem = analysis.memory_analysis_dict(lowered.argument_bytes(), rec)
    flops = costs["dot_flops"]
    # memory term: the dots' operands and results, the kernels' bytes and
    # the collectives' (``touch_bytes``, every result × 2, is the unfused
    # upper bound)
    hbm = costs["dot_bytes"] + costs["kernel_bytes"] + costs[
        "collective_bytes"]
    terms = analysis.roofline_terms(
        flops, hbm, costs["collective_bytes"],
        intra_node_bytes=costs["collective_bytes_intra"])
    n_dev = lowered.mesh.size() if hasattr(lowered.mesh, "size") else 1
    mflops = analysis.model_flops(pair.cfg, INPUT_SHAPES[pair.shape_name],
                                  pair.kind) / n_dev
    return {
        "mode": pair.mode,
        "trace_s": round(trace_s, 2),
        "memory": mem,
        "argument_bytes_bf16": lowered.argument_bytes(torch.bfloat16),
        "fits": mem["peak_bytes"] <= analysis.HBM_BYTES,
        "op_costs": costs,
        "kernels": dict(rec.kernels),
        # the temporaries alive at the peak, by the op that made each
        "peak_by_op": dict(sorted(rec.peak_by_op.items(),
                                  key=lambda kv: -kv[1])),
        "roofline": terms,
        "model_flops_per_device": mflops,
        "useful_flops_ratio": (mflops / flops) if flops else None,
    }


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, verbose: bool = True) -> dict:
    mesh = production_device_mesh(multi_pod)
    label = "2x16x16" if multi_pod else "16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": label,
              "n_devices": mesh.size()}
    t0 = time.time()
    try:
        lowered = specs.lower_pair(arch, shape_name, mesh)
        rec = lowered.trace()
        result.update({"ok": True, **pair_report(lowered, rec,
                                                 time.time() - t0)})
        if verbose:
            mem, terms = result["memory"], result["roofline"]
            print(f"[OK] {arch} × {shape_name} × {label} "
                  f"(mode={result['mode']}, {result['trace_s']} s)")
            print(f"     memory/device: args={mem['argument_bytes']/2**30:.2f}"
                  f" GiB temp={mem['temp_bytes']/2**30:.2f} GiB "
                  f"peak={mem['peak_bytes']/2**30:.2f} GiB "
                  f"fits={result['fits']}")
            print(f"     flops/device={result['op_costs']['dot_flops']:.3e} "
                  f"coll/device="
                  f"{result['op_costs']['collective_bytes']:.3e} "
                  f"useful={result['useful_flops_ratio']}")
            print(f"     roofline: compute={terms['compute_s']*1e3:.2f}ms "
                  f"memory={terms['memory_s']*1e3:.2f}ms "
                  f"collective={terms['collective_s']*1e3:.2f}ms "
                  f"→ {terms['dominant']}-bound")
    except Exception as e:                                # noqa: BLE001
        # a pair that cannot trace is reported, with its error, and
        # counted as failed: the run exits 1
        result.update({"ok": False, "trace_s": round(time.time() - t0, 2),
                       "error": f"{type(e).__name__}: {e}"[:2000],
                       "traceback": traceback.format_exc()[-4000:]})
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {label}: "
                  f"{result['error'][:300]}")
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{arch}__{shape_name}__{label}.json"
    (out_dir / fname).write_text(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        pairs = shape_pairs()
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    # the fake group comes first, before any mesh (the reference's
    # XLA_FLAGS line)
    start_fake_group(512 if meshes[0] else 256)
    out_dir = pathlib.Path(args.out)
    failures = 0
    for multi_pod in meshes:
        for arch, shape_name in pairs:
            res = run_pair(arch, shape_name, multi_pod, out_dir)
            failures += 0 if res.get("ok") else 1
    print(f"\ndry-run complete: {len(pairs) * len(meshes) - failures} ok, "
          f"{failures} failed")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
