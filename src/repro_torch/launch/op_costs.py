"""Op-level cost recording: the port's counterpart of
``repro.launch.hlo_parse``.

The reference reads costs from a compiled, partitioned HLO module. The
port has no compiled module: a step is eager PyTorch, so :class:`OpCosts`
(a ``TorchDispatchMode``) watches the ops the step dispatches, keeps them
in order (the port's jaxpr, which ``analysis.contracts`` walks) and sums,
per device, what ``hlo_costs`` sums:

* ``dot_flops`` — 2 · out elements · contracted size of every ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``addmv`` and ``dot`` (what
  ``matmul``, ``einsum`` and ``linear`` decompose into), plus the FLOPs
  each hand-written kernel reports (``obs.cuda_watch.report_kernel``): a
  ctypes launch passes no dispatcher, so a wrapper reports the dot FLOPs
  of its plain version itself. ``kernel_flops`` and ``kernel_bytes`` keep
  the kernels' share apart.
* ``dot_bytes`` — the dots' operand and result bytes.
* ``<kind>_bytes`` and ``<kind>_count`` for the collective kinds of the
  HLO (all-gather, all-reduce (bytes × 2), reduce-scatter, all-to-all,
  collective-permute): the result bytes of the functional collectives
  (``_c10d_functional.*``, what DTensor issues) and of the in-place ones
  (``c10d.*``, what ``dist.all_gather`` and ``dist.all_reduce`` issue); a
  point-to-point exchange (``batch_isend_irecv``, dispatched as
  ``c10d.send`` and ``c10d.recv_``) counts once, at the receiver, as a
  collective-permute. ``collective_bytes`` is their sum and
  ``collective_bytes_intra`` the part whose group lies within one node
  (``NODE_SIZE`` consecutive ranks).
* ``touch_bytes`` — Σ result bytes × 2 over every op that is not a view.

**Per device.** Over a ``DeviceMesh`` an op on DTensors reaches the mode
at global shapes; the mode hands it back to DTensor (``NotImplemented``),
which redistributes its operands as its sharding rule asks and runs the
op on the local shards, and those local ops and collectives come through
the mode in turn. So every count is of what one device (rank 0 of the
group) does. The ops DTensor runs at global shapes to work out a result's
shape (``ShardingPropagator._propagate_tensor_meta_non_cached``) are no
device's work and are not recorded.

**Folding.** The port's steps are Python loops: 2P member evaluations, L
layers, the slab walk. :meth:`OpCosts.repeat` records one pass with a
multiplier (``hlo_parse._multipliers`` applies XLA's trip counts the same
way), and :func:`repeat_map` / :func:`passes` run one pass of a loop
under it when the active recorder folds. They are used only where the
passes are the same ops at the same shapes.

**Memory.** The live bytes of the storages that recorded ops made,
counted until the storage dies (``memory()``): the most alive at once,
and what is alive now; ``exit_memory`` is the same taken as the recorder's
scope closed, while the caller still held the step's results.
``peak_by_op`` splits the most alive at once by the op that made each
storage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from ..obs import cuda_watch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
NODE_SIZE = 8           # the H100s of one node, joined by NVLink

_aten = torch.ops.aten
# op → (index of the left operand, its contracted dim)
_DOTS = {
    _aten.mm.default: (0, -1),
    _aten.bmm.default: (0, -1),
    _aten.addmm.default: (1, -1),
    _aten.baddbmm.default: (1, -1),
    _aten.mv.default: (0, -1),
    _aten.addmv.default: (1, -1),
    _aten.dot.default: (0, 0),
}

_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_INPLACE = {
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "collective-permute",
}


@dataclasses.dataclass
class OpRecord:
    """One dispatched op (or kernel report, ``name`` ``kernel:<name>``):
    its inputs' and results' (shape, dtype, device) and the multiplier of
    the ``repeat`` scopes around it.
    ``kind`` is the collective kind or None; ``group`` the collective's
    group size. ``outputs`` stays None when the op raised."""

    name: str
    mult: float
    inputs: List[tuple]
    outputs: Optional[List[tuple]] = None
    kind: Optional[str] = None
    group: Optional[int] = None
    flops: float = 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _desc(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, str(t.device))


def _storage_id(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _group_ranks(args) -> Optional[List[int]]:
    """The ranks of a collective's group: a functional collective names
    it (its last string argument), an in-place one passes the group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except (ValueError, RuntimeError):
                continue
        if isinstance(a, torch._C.ScriptObject):
            try:
                return dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(a))
            except (AttributeError, ValueError, RuntimeError):
                continue
    return None


def collective_kind(func) -> Optional[str]:
    """The HLO kind a collective op counts as, None for other ops."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_c10d_functional":
        return _FUNCTIONAL.get(name)
    if ns == "c10d":
        return _INPLACE.get(name)
    return None


_ACTIVE: List["OpCosts"] = []
# > 0 while DTensor works out an op's global result shape: it runs the op
# on fake tensors of the global shapes, through the active modes, and no
# device runs that
_SHAPE_PROPAGATION = [0]


@functools.lru_cache(maxsize=None)
def _unrecorded_shape_propagation() -> None:
    """Wrap DTensor's result-shape propagation so the recorders skip the
    ops it runs (it is shape arithmetic, not work of any device)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    method = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(method)
    def propagate(self, *args, **kwargs):
        _SHAPE_PROPAGATION[0] += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            _SHAPE_PROPAGATION[0] -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate


def active() -> Optional["OpCosts"]:
    """The innermost recorder in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class OpCosts(TorchDispatchMode):
    """Records the ops dispatched under it (see the module note).

    ``fold``: whether :func:`repeat_map` and :func:`passes` fold their
    loops to one pass under this recorder. ``keep_ops``: whether to keep
    the ordered op list (``ops``); the totals are kept either way."""

    def __init__(self, *, fold: bool = False, keep_ops: bool = True):
        super().__init__()
        self.fold, self.keep_ops = fold, keep_ops
        self.ops: List[OpRecord] = []
        self.totals: Dict[str, float] = {
            "dot_flops": 0.0, "dot_bytes": 0.0, "touch_bytes": 0.0,
            "kernel_flops": 0.0, "kernel_bytes": 0.0,
            "collective_bytes_intra": 0.0,
            **{f"{k}_bytes": 0.0 for k in COLLECTIVES},
            **{f"{k}_count": 0.0 for k in COLLECTIVES}}
        self.kernels: Dict[str, float] = {}
        self._mult = 1.0
        self._live: Dict[int, tuple] = {}
        self._live_by_op: Dict[str, int] = {}
        self.peak_by_op: Dict[str, int] = {}
        self.exit_memory: Dict[str, float] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._kernel_cm = None

    # -- scopes ------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        self._kernel_cm = cuda_watch.on_kernel_report(self._on_kernel)
        self._kernel_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._kernel_cm.__exit__(None, None, None)
            _ACTIVE.remove(self)
            # what the recorded ops left alive as the scope closed: the
            # step's results, while its caller still holds them
            self.exit_memory = self.memory()

    @contextlib.contextmanager
    def repeat(self, n: int) -> Iterator[None]:
        """Everything recorded inside counts ``n`` times."""
        prev = self._mult
        self._mult = prev * n
        try:
            yield
        finally:
            self._mult = prev

    # -- recording ---------------------------------------------------------
    def _on_kernel(self, name: str, flops: float, nbytes: float) -> None:
        m = self._mult
        self.totals["dot_flops"] += m * flops
        self.totals["kernel_flops"] += m * flops
        self.totals["kernel_bytes"] += m * nbytes
        self.kernels[name] = self.kernels.get(name, 0.0) + m
        if self.keep_ops:
            self.ops.append(OpRecord(name=f"kernel:{name}", mult=m,
                                     inputs=[], outputs=[], flops=flops))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func.namespace == "profiler":
            # a profiler range's enter and exit (``obs.regions.region``
            # under a profiler) annotate the step and do no work
            return func(*args, **kwargs)
        if any(t.__name__ == "DTensor" for t in types):
            # let DTensor run first: its local ops, and the collectives of
            # the redistributions it makes, then come through this mode
            # at the shapes each device holds
            _unrecorded_shape_propagation()
            return NotImplemented
        if _SHAPE_PROPAGATION[0]:
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        rec = OpRecord(name=str(func), mult=self._mult,
                       inputs=[_desc(t) for t in ins])
        if self.keep_ops:
            self.ops.append(rec)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        rec.outputs = [_desc(t) for t in outs]
        self._account(func, args, ins, outs, rec)
        return out

    def _account(self, func, args, ins, outs, rec: OpRecord) -> None:
        m, tot = rec.mult, self.totals
        kind = collective_kind(func)
        if kind is not None:
            buffers = (_tensors(args[0]) if func.namespace == "c10d"
                       else outs)
            nbytes = sum(_nbytes(t) for t in buffers)
            nbytes *= 2.0 if kind == "all-reduce" else 1.0
            ranks = _group_ranks(args)
            rec.kind, rec.group = kind, None if ranks is None else len(ranks)
            tot[f"{kind}_bytes"] += m * nbytes
            tot[f"{kind}_count"] += m
            if ranks is not None and len({r // NODE_SIZE
                                          for r in ranks}) == 1:
                tot["collective_bytes_intra"] += m * nbytes
            return
        if func.namespace in ("_c10d_functional", "c10d"):
            return
        if func in _DOTS and outs:
            which, dim = _DOTS[func]
            lhs = args[which]
            rec.flops = 2.0 * outs[0].numel() * lhs.shape[dim]
            tot["dot_flops"] += m * rec.flops
            operands = [a for a in args[:which + 2]
                        if isinstance(a, torch.Tensor)]
            tot["dot_bytes"] += m * (sum(_nbytes(a) for a in operands)
                                     + _nbytes(outs[0]))
        if func.is_view:
            return
        tot["touch_bytes"] += m * 2.0 * sum(_nbytes(t) for t in outs)
        # a result that shares an operand's storage (an in-place op, an
        # ``out=``) allocated nothing
        held = {_storage_id(t) for t in ins}
        for t in outs:
            self._track(t, held, rec.name)

    def _track(self, t: torch.Tensor, held: set, op: str) -> None:
        sid = _storage_id(t)
        if sid is None or sid in held or sid in self._live:
            return
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        self._sweep()
        size = st.nbytes()
        self._live[sid] = (ref, size, op)
        self._live_by_op[op] = self._live_by_op.get(op, 0) + size
        self.live_bytes += size
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_op = {k: b for k, b in self._live_by_op.items()
                               if b}

    def _sweep(self) -> None:
        dead = [k for k, (ref, _, _) in self._live.items() if ref.expired()]
        for k in dead:
            _, size, op = self._live.pop(k)
            self.live_bytes -= size
            self._live_by_op[op] -= size

    # -- results -----------------------------------------------------------
    def costs(self) -> Dict[str, float]:
        """``hlo_costs``' keys (per device), with the kernels' share."""
        out = dict(self.totals)
        out["collective_bytes"] = sum(out[f"{k}_bytes"] for k in COLLECTIVES)
        return out

    def memory(self) -> Dict[str, float]:
        """Bytes of the storages the recorded ops made: the most alive at
        once, and what is still alive (the outputs)."""
        self._sweep()
        return {"temp_peak_bytes": float(self.peak_bytes),
                "output_bytes": float(self.live_bytes)}

    def collectives(self) -> List[tuple]:
        """The ordered (kind, result shapes, group size) of the recorded
        collectives: what every rank must issue alike."""
        return [(r.kind, tuple(o[:2] for o in r.outputs or ()), r.group)
                for r in self.ops if r.kind is not None]


def repeat_map(fn: Callable[[int], Any], n: int) -> List[Any]:
    """``[fn(i) for i in range(n)]``; under a folding recorder, ``fn(0)``
    recorded ``n`` times over and returned n times (the passes must be the
    same ops at the same shapes)."""
    rec = active()
    if rec is None or not rec.fold or n <= 1:
        return [fn(i) for i in range(n)]
    with rec.repeat(n):
        first = fn(0)
    return [first] * n


def passes(n: int) -> Iterator[int]:
    """``range(n)`` for a loop whose passes are the same ops at the same
    shapes; under a folding recorder one pass, counted ``n`` times."""
    rec = active()
    if rec is None or not rec.fold or n <= 1:
        yield from range(n)
        return
    with rec.repeat(n):
        yield 0
