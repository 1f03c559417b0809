"""Layer 2: op contracts over the registered entry points: the port of
``repro.analysis.contracts``.

The reference traces each entry point to a jaxpr and walks it. The port
runs each entry point once on **fake tensors of the card**
(``FakeTensorMode``: shapes, dtypes and devices, no data, nothing
launched; a kernel wrapper takes its shape-only path) under a
``launch.op_costs.OpCosts`` recorder, and walks the ordered list of ops it
dispatched: the port's jaxpr. Off the host a copy to the host is an op of
its own, so it shows. The fake tensors are CUDA's where PyTorch has CUDA;
a build without it cannot index a fake CUDA tensor, and there the meta
device stands in for the card (:func:`fake_device`).

* ``no-host-sync`` (the reference's ``no-host-callback``) — no
  ``_local_scalar_dense`` (``.item()``, ``float()``, a Python branch on a
  tensor), no copy to the CPU, and no op whose result's shape depends on
  data (``nonzero``, ``masked_select``, ``unique``, …): each waits for the
  card and stops a step from being captured as one CUDA graph. A fake run
  that raises ``DataDependentOutputException`` is such a finding, not a
  crash.
* ``stable-carry`` (``strong-scan-carry``) — the state the entry point
  returns has the dtypes, shapes and devices of the state it took: a CUDA
  graph replays into the same buffers, and a state that changes dtype
  (a float64 scalar, a CPU counter) breaks the replay or the next step.
  A field exempt by design is named in the entry point with its reason
  (``EntryPoint.carry_exempt``).
* ``rank-collective-parity`` (``branch-collective-parity``) — run once per
  rank on a fake process group of ``min_devices`` ranks, every rank issues
  the same ordered collectives (kind, result shapes, group size): the
  deadlock-freedom contract of the fleet's comm plans.
* ``fused-seam-product`` (``fma-seam-barrier``) — eager PyTorch rounds
  every product, so the seam's risk is a fused multiply-add: no rank ≥ 2
  ``addcmul``, ``addmm``, ``baddbmm``, ``addmv``, ``addbmm`` or ``lerp`` on
  a registered seam leaf (its products must round as the solo engine's).
* ``product-ratchet`` (``min_barriers``) — the traced program keeps at
  least ``min_products`` separately rounded rank ≥ 2 products (``mul``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .findings import Finding
from .registry import EntryPoint, iter_entry_points

_HOST_READS = ("aten._local_scalar_dense", "aten.item")
_DATA_DEPENDENT = ("aten.nonzero", "aten.masked_select", "aten.unique",
                   "aten._unique", "aten.unique_consecutive",
                   "aten.unique_dim", "aten.repeat_interleave.Tensor",
                   "aten.bincount", "aten.argwhere")
_FUSED = ("aten.addcmul", "aten.addmm", "aten.baddbmm", "aten.addmv",
          "aten.addbmm", "aten.lerp", "aten.addr")
_PRODUCTS = ("aten.mul.Tensor", "aten.mul_.Tensor", "aten.mul.out")


def check_no_host_sync(rec) -> List[str]:
    out = []
    for op in rec.ops:
        if op.name.startswith(_HOST_READS):
            out.append(f"{op.name}: a tensor read on the host")
        elif op.name.startswith(_DATA_DEPENDENT):
            out.append(f"{op.name}: a result whose shape depends on data")
        elif op.outputs and any(d[2] == "cpu" for d in op.outputs) and any(
                d[2] != "cpu" for d in op.inputs):
            out.append(f"{op.name}: a copy from the card to the host")
    return out


def check_fused_seam_product(rec) -> List[str]:
    return [f"{op.name} (rank {len(op.outputs[0][0])}): a fused "
            f"multiply-add on the seam rounds its product with the add"
            for op in rec.ops
            if op.name.startswith(_FUSED) and op.outputs
            and len(op.outputs[0][0]) >= 2]


def count_products(rec) -> int:
    return sum(1 for op in rec.ops
               if op.name in _PRODUCTS and op.outputs
               and len(op.outputs[0][0]) >= 2)


def _leaves(tree: Any, prefix: str = "") -> Iterable[Tuple[str, Any]]:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name),
                               f"{prefix}.{f.name}" if prefix else f.name)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _describe(v: Any):
    if isinstance(v, torch.Tensor):
        return ("tensor", v.dtype, tuple(v.shape), str(v.device))
    if isinstance(v, torch.Generator):
        return ("generator", str(v.device))
    if isinstance(v, (bool, int, float, str, type(None))):
        return (type(v).__name__, v)      # a host value: held constant
    return (type(v).__name__,)


def check_stable_carry(pairs: Dict[str, Tuple[list, list]],
                       exempt: Dict[str, str]) -> List[str]:
    """``pairs``: state name → (its leaves as taken, as returned), each a
    list of (field path, description) from :func:`snapshot`."""
    out = []
    for name, (before, after) in pairs.items():
        a, b = dict(before), dict(after)
        if set(a) != set(b):
            out.append(f"{name}: fields {sorted(set(a) ^ set(b))} appear or "
                       f"vanish across the step")
            continue
        for path, desc in a.items():
            if path.rsplit(".", 1)[-1] in exempt:
                continue
            if desc != b[path]:
                out.append(f"{name}.{path}: {desc} in, {b[path]} out (a "
                           f"replay into the same buffers cannot hold it)")
    return out


def snapshot(tree: Any) -> list:
    """What ``stable-carry`` compares of a state: (field path, (kind,
    dtype, shape, device)) of each leaf, taken when called (a step may
    update its state in place)."""
    return [(p, _describe(v)) for p, v in _leaves(tree)]


_HINTS = {
    "no-host-sync": "keep per-step values on the device; drain them with "
                    "obs.cuda_watch.device_get outside the step",
    "stable-carry": "build state initializers with explicit dtypes and "
                    "devices, and keep counters on the device",
    "rank-collective-parity": "issue the same collectives on every rank "
                              "(pad with inert ones), or hoist the "
                              "rank-dependent one out",
    "fused-seam-product": "round the product before the add "
                          "(acc + w * x, not torch.addcmul(acc, w, x))",
}

CONTRACT_IDS = ("no-host-sync", "stable-carry", "rank-collective-parity",
                "fused-seam-product", "product-ratchet")


@dataclasses.dataclass
class RunResult:
    """One entry point run on one rank: the recorder, the state pairs for
    ``stable-carry`` and the findings the run itself raised."""

    rec: Any
    pairs: Dict[str, Tuple[Any, Any]]
    errors: List[Finding]


def fake_device() -> torch.device:
    """The device of the contract layer's fake tensors: ``cuda:0``, or
    where PyTorch is built without CUDA (whose indexing of a fake CUDA
    tensor takes a CUDA device guard it lacks) the meta device, which
    stands in for the card: a copy to the host is an op there too."""
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("meta")


def run_entry_point(ep: EntryPoint, device=None) -> RunResult:
    """Build and run ``ep`` once on fake tensors of ``device``
    (:func:`fake_device` by default) under a recorder (on the current
    process group, if it needs one)."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException,
                                               FakeTensorMode)

    from ..launch.op_costs import OpCosts
    path = f"<{ep.name}>"
    dev = fake_device() if device is None else torch.device(device)
    rec = OpCosts(keep_ops=True)
    pairs: Dict[str, Tuple[Any, Any]] = {}
    errors: List[Finding] = []
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args, kwargs = ep.build(dev)
            before = {name: snapshot(args[i]) for name, i, _ in ep.carry}
            with rec:
                out = fn(*args, **kwargs)
            pairs = {name: (before[name], snapshot(out[j]))
                     for name, _, j in ep.carry}
    except (DataDependentOutputException,
            DynamicOutputShapeException) as e:
        errors.append(Finding(
            rule="no-host-sync", path=path, line=0,
            message=f"the fake run raised {type(e).__name__}: {e} (a value "
                    f"read on the host, or a shape that depends on data)",
            hint=_HINTS["no-host-sync"]))
    except Exception as e:  # a registered entry point must always run
        errors.append(Finding(
            rule="entry-point-trace", path=path, line=0,
            message=f"entry point failed to run on fake tensors: "
                    f"{type(e).__name__}: {e}",
            hint="the registry contract is that build(device) returns a "
                 "runnable (fn, args, kwargs); fix the hook"))
    return RunResult(rec=rec, pairs=pairs, errors=errors)


def check_entry_point(ep: EntryPoint) -> List[Finding]:
    """Run one entry point (once per rank of a fake group of
    ``min_devices`` ranks when it needs more than one) and check its
    contracts. Returns findings (empty = clean)."""
    path = f"<{ep.name}>"
    if ep.min_devices > 1:
        from ..launch.dryrun import start_fake_group
        runs = []
        for rank in range(ep.min_devices):
            start_fake_group(ep.min_devices, rank)
            runs.append(run_entry_point(ep))
    else:
        runs = [run_entry_point(ep)]
    out: List[Finding] = []
    for r in runs:
        out.extend(r.errors)
    if out:
        return out
    first = runs[0]
    for name in ep.contracts:
        if name == "no-host-sync":
            msgs = check_no_host_sync(first.rec)
        elif name == "stable-carry":
            msgs = check_stable_carry(first.pairs, dict(ep.carry_exempt))
        elif name == "rank-collective-parity":
            sigs = [r.rec.collectives() for r in runs]
            msgs = [f"ranks 0 and {i} issue different collective sequences "
                    f"({sigs[0]} vs {s}): the group deadlocks"
                    for i, s in enumerate(sigs[1:], start=1)
                    if s != sigs[0]]
        elif name == "fused-seam-product":
            msgs = check_fused_seam_product(first.rec)
        else:
            raise ValueError(f"unknown contract {name!r}")
        for msg in msgs:
            out.append(Finding(rule=name, path=path, line=0, message=msg,
                               hint=_HINTS.get(name, "")))
    if ep.min_products:
        got = count_products(first.rec)
        if got < ep.min_products:
            out.append(Finding(
                rule="product-ratchet", path=path, line=0,
                message=f"{got} separately rounded rank ≥ 2 products in the "
                        f"run, registered minimum is {ep.min_products}: a "
                        f"seam product was fused or dropped",
                hint="restore the product, or if the seam genuinely moved, "
                     "update min_products in the module's "
                     "analysis_entry_points() with a comment"))
    return out


def run_contracts(names: Optional[Iterable[str]] = None) -> List[Finding]:
    """Check every registered entry point (or the named subset)."""
    eps = iter_entry_points()
    if names is not None:
        wanted = set(names)
        unknown = wanted - {ep.name for ep in eps}
        if unknown:
            raise ValueError(f"unknown entry points: {sorted(unknown)}")
        eps = [ep for ep in eps if ep.name in wanted]
    out: List[Finding] = []
    try:
        for ep in eps:
            out.extend(check_entry_point(ep))
    finally:
        import torch.distributed as dist

        from ..launch.dryrun import is_fake_group
        if is_fake_group():
            dist.destroy_process_group()
    return out
