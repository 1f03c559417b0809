"""Placement modes, abstract inputs and lowering: the port of
``repro.launch.specs``.

``classify(arch, shape, mesh)`` picks an (architecture × input shape)
pair's placement mode: ``replica`` (one parameter replica an agent),
``consensus`` (one shared θ, the population time-multiplexed) or
``serve``. ``input_specs`` gives every input of the pair's step as meta
tensors (shapes and dtypes, no memory) with its partition specs
(``distributed.sharding``), and ``build_step`` builds the step itself:
``netes_dist.make_replica_train_step``,
``netes_dist.make_consensus_train_step``, or the serve steps.

The abstract trees keep the reference's ``PARAM_DTYPE`` (bfloat16). The
steps train in float32: ``transformer.loss_fn`` takes float32 (the kernel
path) or float64 (the plain yardstick) parameters only.

``lower_pair`` (and ``lower``, for a pair cut to size) is the reference's
lowering without a compiler: it returns a ``LoweredPair`` whose
``trace()`` runs the step once on fake tensors (``FakeTensorMode``) under
an ``op_costs.OpCosts`` recorder: over a ``DeviceMesh`` of more than one
device the arguments are DTensors of the pair's placements
(``named_shardings``) and the step runs in its ``sharding_context``;
``launch.dryrun`` reads the recorder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Union

import torch

from ..comm import channel as comm_channel
from ..comm.channel import ChannelSpec, ChannelState
from ..configs import INPUT_SHAPES, get_config
from ..configs.base import ModelConfig
from ..core import topology_repr, topology_sched
from ..core.netes import NetESConfig
from ..core.topology import TopologySpec
from ..core.topology_sched import ScheduleSpec
from ..core.tree import tree_map
from ..distributed import netes_dist, sharding
from ..distributed.sharding import P
from ..models import transformer

# Archs trained in consensus mode: their per-agent replica (θ, a
# perturbed copy and transients at 2.2 × the bfloat16 parameters) does
# not fit on a 16-wide model-parallel group, so one θ is shared and the
# population time-multiplexed.
CONSENSUS_ARCHS = (
    "llama4-maverick-400b-a17b",     # ≈ 400 B parameters
    "llama4-scout-17b-a16e",         # ≈ 109 B total (17 B active)
    "jamba-v0.1-52b",                # 52 B
    "moonlight-16b-a3b",             # 16 B (port-only; 3 B active)
    "moonlight-16b-a3b-smoke",       # its CPU tests' size
)

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """One (arch × shape × mesh) combination, as ``build_step`` takes it.

    ``topo`` is the ``TopologySpec`` a topology sweep passed to
    ``classify`` (None otherwise): ``build_step`` makes it a
    representation-selected ``Topology`` and the step ignores its runtime
    ``adj``. ``sched`` (needs ``topo``) compiles with it into a
    ``TopologySchedule``, and the step takes and returns its state;
    ``chan`` compiles into a ``Channel``, and the step takes and returns
    its state."""

    arch: str
    shape_name: str
    mode: str                 # replica | consensus | serve
    kind: str                 # train | prefill | decode
    cfg: ModelConfig
    n_agents: int
    topo: Optional[TopologySpec] = None
    sched: Optional[ScheduleSpec] = None
    chan: Optional[ChannelSpec] = None


def classify(arch: str, shape_name: str, mesh,
             topo_spec: Optional[TopologySpec] = None,
             sched_spec: Optional[ScheduleSpec] = None,
             chan_spec: Optional[ChannelSpec] = None) -> PairSpec:
    """The pair's mode and population: a train shape is ``consensus``
    for ``CONSENSUS_ARCHS``, with P = global batch ÷ the agent axes' size
    (each member's microbatch spans all data axes), else ``replica`` with
    one agent per agent-axis index; prefill and decode shapes are
    ``serve``."""
    if sched_spec is not None and topo_spec is None:
        raise ValueError("a topology schedule needs a TopologySpec to "
                         "schedule (pass topo_spec)")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    kind = shape["kind"]
    topo = None
    if kind == "train":
        mode = "consensus" if arch in CONSENSUS_ARCHS else "replica"
        if mode == "consensus":
            n = shape["global_batch"] // sharding.n_agents(mesh)
        else:
            n = sharding.n_agents(mesh)
        # a Topology makes the step ignore its runtime ``adj``: made only
        # when a spec is asked for
        if topo_spec is not None:
            topo = (topo_spec if topo_spec.n_agents == n
                    else dataclasses.replace(topo_spec, n_agents=n))
    else:
        if sched_spec is not None:
            raise ValueError(f"topology schedules only apply to train "
                             f"shapes, not {kind!r}")
        if chan_spec is not None:
            raise ValueError(f"agent-link channels only apply to train "
                             f"shapes, not {kind!r}")
        mode, n = "serve", 0
    return PairSpec(arch=arch, shape_name=shape_name, mode=mode, kind=kind,
                    cfg=cfg, n_agents=n, topo=topo, sched=sched_spec,
                    chan=chan_spec)


# ---------------------------------------------------------------------------
# abstract trees (meta tensors)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@functools.lru_cache(maxsize=32)
def _abstract_params(cfg: ModelConfig, dtype) -> Any:
    return transformer.init_params(cfg, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig, dtype=PARAM_DTYPE) -> Any:
    """``transformer.init_params``' tree on the meta device (made once per
    config; each call returns a tree of its own over the same leaves)."""
    return tree_map(lambda leaf: leaf, _abstract_params(cfg, dtype))


def stack_abstract(tree: Any, n: int) -> Any:
    """Every leaf with a leading axis of ``n``."""
    return tree_map(lambda leaf: _meta((n,) + tuple(leaf.shape),
                                       leaf.dtype), tree)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=PARAM_DTYPE) -> Any:
    """``transformer.init_cache``'s tree on the meta device."""
    return transformer.init_cache(cfg, batch, max_len, dtype, device=META)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _train_batch_specs(cfg: ModelConfig, seq: int, global_batch: int,
                       n_groups: int, dtype=PARAM_DTYPE) -> Dict[str, Any]:
    """A train batch (n_groups, per_group, ...) for replica/consensus."""
    per = global_batch // n_groups
    if per < 1:
        raise ValueError(f"{cfg.name}: a global batch of {global_batch} "
                         f"over {n_groups} groups")
    s_text = seq
    out: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        s_text = seq - cfg.num_patches
        out["patch_embeds"] = _meta((n_groups, per, cfg.num_patches,
                                     cfg.d_model), dtype)
    elif cfg.frontend == "audio":
        out["frames"] = _meta((n_groups, per, cfg.encoder_seq, cfg.d_model),
                              dtype)
    out["tokens"] = _meta((n_groups, per, s_text), torch.int32)
    out["labels"] = _meta((n_groups, per, s_text), torch.int32)
    return out


def _serve_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                       dtype=PARAM_DTYPE) -> Dict[str, Any]:
    s_text = seq
    out: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        s_text = seq - cfg.num_patches
        out["patch_embeds"] = _meta((batch, cfg.num_patches, cfg.d_model),
                                    dtype)
    elif cfg.frontend == "audio":
        out["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model), dtype)
    out["tokens"] = _meta((batch, s_text), torch.int32)
    return out


def input_specs(arch: str, shape_name: str, mesh, dtype=PARAM_DTYPE,
                topo_spec: Optional[TopologySpec] = None,
                sched_spec: Optional[ScheduleSpec] = None,
                chan_spec: Optional[ChannelSpec] = None) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of the pair's step, and their
    partition specs: ``{"pair", "args", "specs"}``. A train step's inputs
    are ``params``, ``adj``, ``batch`` and ``draws`` (the reference's
    ``key``: here the broadcast's uniform β, a 0-d float32; ε is a
    function, ``netes_dist.StepDraws.noise``), then ``sched`` and ``chan``
    where the pair has them."""
    pair = classify(arch, shape_name, mesh, topo_spec=topo_spec,
                    sched_spec=sched_spec, chan_spec=chan_spec)
    return pair_input_specs(pair, INPUT_SHAPES[shape_name], mesh, dtype)


def pair_input_specs(pair: PairSpec, shape: Dict[str, Any], mesh,
                     dtype=PARAM_DTYPE) -> Dict[str, Any]:
    """``input_specs`` of a pair already classified (or cut: fewer
    layers, a smaller population) at ``shape`` (``seq_len`` and
    ``global_batch``)."""
    cfg = pair.cfg
    seq, gbatch = shape["seq_len"], shape["global_batch"]
    params_abs = abstract_params(cfg, dtype)

    if pair.kind == "train":
        n = pair.n_agents
        if pair.mode == "replica":
            params_abs = stack_abstract(params_abs, n)
        batch_abs = _train_batch_specs(cfg, seq, gbatch, n, dtype)
        args = {"params": params_abs, "adj": _meta((n, n), torch.float32),
                "batch": batch_abs, "draws": _meta((), torch.float32)}
        specs = {
            "params": sharding.param_pspecs(cfg, params_abs, pair.mode, mesh),
            "adj": P(None, None),
            "batch": sharding.train_batch_pspecs(cfg, batch_abs, pair.mode,
                                                 mesh),
            "draws": P(),
        }
        if pair.sched is not None:
            # the schedule's state from a concrete init on the CPU (its
            # base graph is built on the host), replicated
            state = _compile_pair_schedule(pair).init(device="cpu")
            args["sched"] = dataclasses.replace(
                state, topo=_meta_topology(state.topo),
                u=None if state.u is None else _meta(state.u.shape,
                                                     state.u.dtype))
            specs["sched"] = P()
        if pair.chan is not None:
            channel = comm_channel.compile_channel(pair.chan, n)
            args["chan"] = channel.init(params_abs)
            last = specs["params"] if channel.event_stage is not None else None
            specs["chan"] = ChannelState(seed=P(), draws=P(), last_sent=last,
                                         msgs=P())
    elif pair.kind == "prefill":
        batch_abs = _serve_batch_specs(cfg, seq, gbatch, dtype)
        args = {"params": params_abs, "batch": batch_abs}
        specs = {
            "params": sharding.param_pspecs(cfg, params_abs, "serve", mesh),
            "batch": sharding.serve_batch_pspecs(cfg, batch_abs, mesh,
                                                 gbatch),
        }
    else:  # decode
        cache_abs = abstract_cache(cfg, gbatch, seq, dtype)
        args = {"params": params_abs,
                "token": _meta((gbatch, 1), torch.int32),
                "cache": cache_abs,
                "pos": _meta((gbatch,), torch.int32)}
        ax = sharding.data_axes(mesh)
        bspec = P(ax) if gbatch % sharding.n_agents(mesh) == 0 else P(None)
        specs = {
            "params": sharding.param_pspecs(cfg, params_abs, "serve", mesh),
            "token": P(*bspec, None),
            "cache": sharding.cache_pspecs(cfg, cache_abs, mesh, gbatch),
            "pos": bspec,
        }
    return {"pair": pair, "args": args, "specs": specs}


def _meta_topology(topo: topology_repr.Topology) -> topology_repr.Topology:
    return dataclasses.replace(topo, **{
        f.name: _meta(getattr(topo, f.name).shape,
                      getattr(topo, f.name).dtype)
        for f in dataclasses.fields(topo)
        if isinstance(getattr(topo, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _compile_schedule_cached(sched_spec: ScheduleSpec,
                             topo_spec: TopologySpec):
    return topology_sched.compile_schedule(sched_spec, topo_spec)


def _compile_pair_schedule(pair: PairSpec):
    """One compiled schedule per (sched, topo) pair: ``compile_schedule``
    builds the O(N²) base graph on the host, and both ``input_specs`` and
    ``build_step`` need it."""
    return _compile_schedule_cached(pair.sched, pair.topo)


def build_step(pair: PairSpec, mesh, ncfg: Optional[NetESConfig] = None,
               device: Union[str, torch.device] = "cuda"):
    """Returns ``(fn, arg_order)``: ``fn`` takes the values of
    ``input_specs``' ``args`` in ``arg_order``. A train pair's topology is
    built on ``device``; the step runs where its arguments are."""
    ncfg = ncfg or NetESConfig()
    cfg = pair.cfg
    if pair.kind == "train":
        schedule = (_compile_pair_schedule(pair)
                    if pair.sched is not None else None)
        channel = (comm_channel.compile_channel(pair.chan, pair.n_agents)
                   if pair.chan is not None else None)
        topo = (topology_repr.from_spec(pair.topo, device=device)
                if pair.topo is not None and schedule is None else None)
        if pair.mode == "replica":
            step = netes_dist.make_replica_train_step(
                cfg, ncfg, pair.n_agents, topology=topo, schedule=schedule,
                channel=channel)
        else:
            step = netes_dist.make_consensus_train_step(
                cfg, ncfg, pair.n_agents, topology=topo, schedule=schedule,
                channel=channel)
        order = ("params", "adj", "batch", "draws")
        if schedule is not None:
            order = order + ("sched",)
        if channel is not None:
            order = order + ("chan",)
        return step, order
    if pair.kind == "prefill":
        return netes_dist.make_prefill_step(cfg), ("params", "batch")
    return (netes_dist.make_decode_step(cfg),
            ("params", "token", "cache", "pos"))


# ---------------------------------------------------------------------------
# lowering: a traced step on fake tensors
# ---------------------------------------------------------------------------

def named_shardings(mesh, spec_tree: Any) -> Any:
    """Every ``P`` of ``spec_tree`` as its ``torch.distributed.tensor``
    placements over the ``DeviceMesh`` ``mesh``."""
    return _map_specs(lambda s: sharding.to_placements(s, mesh), spec_tree)


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not dataclasses.is_dataclass(tree):
        return type(tree)(_map_specs(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_specs(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _zip_specs(fn, args, specs):
    """``fn(leaf, spec)`` over ``args``' tensors, ``specs`` matching the
    tree (a spec over a subtree applies to each of its leaves)."""
    if isinstance(args, torch.Tensor):
        return fn(args, specs)
    if isinstance(args, dict):
        return {k: _zip_specs(fn, v, specs[k] if isinstance(specs, dict)
                              else specs) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        sub = (specs if isinstance(specs, P) or not isinstance(
            specs, (list, tuple)) else None)
        return type(args)(_zip_specs(fn, v, sub if sub is not None
                                     else specs[i])
                          for i, v in enumerate(args))
    if dataclasses.is_dataclass(args):
        return dataclasses.replace(args, **{
            f.name: _zip_specs(fn, getattr(args, f.name),
                               specs if isinstance(specs, P)
                               else getattr(specs, f.name))
            for f in dataclasses.fields(args)
            if getattr(args, f.name) is not None})
    return args


def named_shape(mesh):
    """What the sharding rules read of a mesh (``axis_names`` and a
    ``shape`` mapping): a ``DeviceMesh`` as a ``NamedShape``, anything
    else as it is."""
    if not _is_device_mesh(mesh):
        return mesh
    from .mesh import NamedShape
    return NamedShape(tuple(mesh.mesh_dim_names),
                      tuple(int(d) for d in mesh.mesh.shape))


@functools.lru_cache(maxsize=None)
def _fake_safe_dtensor() -> None:
    """Two of DTensor's internals read tensor data where the answer needs
    none, which raises under ``FakeTensorMode``; they are replaced by
    equivalents that do not:

    * ``_StridedShard``'s local-size computation (a merged dim sharded
      over two mesh axes, as a (B, S) residual sharded on both becomes in
      a projection's flattened product) builds an index tensor and reads
      it back: it runs with the dispatch modes set aside (it is shape
      arithmetic);
    * ``MaskBuffer.apply_mask`` (a vocabulary-sharded gather's partial
      sum) zeroes the masked entries by boolean indexing, whose shape
      depends on the mask: it zeroes them with ``masked_fill_``, the same
      values with no data-dependent shape."""
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def apply_mask(self, tensor):
        if self.refcount == 0 or self.data is None:
            raise RuntimeError("MaskBuffer has not been materialized")
        mask = self.data
        if mask.numel() == tensor.numel():
            # a gather's mask (also after its trailing unit dim is dropped)
            mask = mask.reshape(tensor.shape)
        else:
            mask = mask[..., None]                # an embedding's rows
        tensor.masked_fill_(mask, 0.0)

    MaskBuffer.apply_mask = apply_mask

    method = _StridedShard.local_shard_size_and_offset

    @functools.wraps(method)
    def local_shard_size_and_offset(self, *args, **kwargs):
        with _disable_current_modes():
            return method(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = local_shard_size_and_offset


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


@dataclasses.dataclass
class LoweredPair:
    """A pair ready to trace: its step, its argument trees as meta
    tensors with their placements, and the sharding context's roles.
    ``trace()`` runs the step once on fake tensors under an
    ``op_costs.OpCosts`` recorder and returns the recorder."""

    pair: PairSpec
    fn: Any
    order: tuple
    args: Dict[str, Any]
    specs: Dict[str, Any]
    roles: Dict[str, P]
    mesh: Any
    device: torch.device

    @property
    def named(self):
        return named_shape(self.mesh)

    @property
    def distributed(self) -> bool:
        return _is_device_mesh(self.mesh) and self.mesh.size() > 1

    def argument_bytes(self, dtype=None) -> float:
        """Per-device bytes of the arguments: each leaf's local shard
        under its placements (``dtype``: counted at that dtype's width,
        e.g. bfloat16 for the reference's accounting)."""
        total = [0.0]

        def leaf(t, spec):
            n = _local_numel(t.shape, spec, self.named)
            width = (torch.empty((), dtype=dtype).element_size()
                     if dtype is not None and t.dtype.is_floating_point
                     else t.element_size())
            total[0] += n * width
            return t

        for k in self.order:
            _zip_specs(leaf, self.args[k], self.specs[k])
        return total[0]

    def fake_args(self, mode) -> list:
        """The step's arguments as fake tensors made under ``mode`` (a
        ``FakeTensorMode``): DTensors of the placements over a mesh of
        more than one device, plain tensors on ``device`` otherwise."""
        from torch.distributed.tensor import DTensor

        def leaf(t, spec):
            if not self.distributed:
                return torch.empty(t.shape, dtype=t.dtype, device=self.device)
            placements = sharding.to_placements(
                sharding.guard_divisibility(spec, t.shape, self.named),
                self.mesh)
            local = torch.empty(_local_shape(t.shape, spec, self.named),
                                dtype=t.dtype, device=self.device)
            return DTensor.from_local(local, self.mesh, placements,
                                      run_check=False, shape=t.shape,
                                      stride=_contiguous_strides(t.shape))

        with mode:
            out = [_zip_specs(leaf, self.args[k], self.specs[k])
                   for k in self.order]
            if "draws" in self.order:
                i = self.order.index("draws")
                out[i] = netes_dist.StepDraws(
                    noise=netes_dist.NoiseStream(0, 0), beta=out[i])
        return out

    def trace(self, *, fold: bool = True, keep_ops: bool = False):
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..distributed.context import sharding_context
        from .op_costs import OpCosts
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args = self.fake_args(mode)
        rec = OpCosts(fold=fold, keep_ops=keep_ops)
        ctx = contextlib.ExitStack()
        if self.distributed:
            _fake_safe_dtensor()
            from torch.distributed.tensor.experimental import \
                implicit_replication
            ctx.enter_context(sharding_context(self.mesh, self.roles))
            # a plain tensor the step makes (positions, masks, rope
            # tables) is the same on every rank: a replicated operand
            ctx.enter_context(implicit_replication())
        with mode, ctx, rec:
            out = self.fn(*args)
        del out
        return rec


def _local_shape(shape, spec, named) -> tuple:
    """``shape``'s block on each device under ``spec`` over the named
    shape ``named`` (dims their axes do not divide are replicated,
    ``guard_divisibility``)."""
    spec = sharding.guard_divisibility(spec, shape, named)
    sizes = named.shape
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        count = 1
        for a in axes:
            count *= sizes[a]
        out.append(int(n) // count)
    return tuple(out)


def _local_numel(shape, spec, named) -> int:
    n = 1
    for d in _local_shape(shape, spec, named):
        n *= d
    return n


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for d in reversed(tuple(shape)):
        strides.append(acc)
        acc *= int(d)
    return tuple(reversed(strides))


def lower_pair(arch: str, shape_name: str, mesh,
               ncfg: Optional[NetESConfig] = None,
               topo_spec: Optional[TopologySpec] = None,
               sched_spec: Optional[ScheduleSpec] = None,
               chan_spec: Optional[ChannelSpec] = None) -> LoweredPair:
    """One (arch × shape × mesh), ready to trace (``LoweredPair.trace``).

    ``mesh``: a ``DeviceMesh`` (over the fake process group of
    ``launch.dryrun``, or any group), whose ``mesh_dim_names`` the specs
    name; or a named shape of one device (``launch.mesh.NamedShape``).
    Over more than one device the arguments are DTensors of their
    placements and the step runs in the pair's ``sharding_context``; on
    one device they are plain tensors on the CPU (``lower`` takes another
    device: fake CUDA tensors on the card). Every kernel takes its
    shape-only path on fake tensors. The arguments are float32, the
    only dtype the port's steps take; ``argument_bytes(torch.bfloat16)``
    gives the reference's bfloat16 accounting beside it."""
    pair = classify(arch, shape_name, named_shape(mesh), topo_spec=topo_spec,
                    sched_spec=sched_spec, chan_spec=chan_spec)
    return lower(pair, mesh, ncfg=ncfg)


def lower(pair: PairSpec, mesh, *, shape: Optional[Dict[str, Any]] = None,
          ncfg: Optional[NetESConfig] = None,
          device: Union[str, torch.device] = "cpu") -> LoweredPair:
    """``lower_pair`` of a ``PairSpec`` (a classified pair, or one cut to
    fewer layers and members), at ``shape`` (its own input shape by
    default). A topology the pair names is built on ``device``."""
    named = named_shape(mesh)
    shape = INPUT_SHAPES[pair.shape_name] if shape is None else shape
    info = pair_input_specs(pair, shape, named, torch.float32)
    fn, order = build_step(pair, named, ncfg, device=device)
    roles = sharding.activation_roles(pair.cfg, pair.mode, named, pair.kind)
    return LoweredPair(pair=pair, fn=fn, order=order, args=info["args"],
                       specs=info["specs"], roles=roles, mesh=mesh,
                       device=torch.device(device))
