"""Sharding rules: the port of ``repro.distributed.sharding``. They map the
parameter, batch and cache trees of a placement mode to partition specs,
as data: the port's :class:`P` (per tensor dimension, a mesh axis, a tuple
of axes, or None), and :func:`to_placements` turns a spec into
``torch.distributed.tensor`` placements over a ``DeviceMesh``.

Modes
-----
``replica``   NetES train: per-agent parameter replicas. Every parameter
              leaf gains a leading agent axis sharded over the agent mesh
              axes (("pod", "data") multi-pod, ("data",) single-pod);
              feature dims follow the per-tensor rules below.
``consensus`` NetES train for archs whose per-agent replica does not fit:
              one shared parameter tree sharded over data and model
              jointly; the population is time-multiplexed (DESIGN.md §2,
              §7.4; ``netes_dist.make_consensus_train_step``).
``serve``     prefill and decode: one parameter tree; batch over the data
              axes, tensor-parallel over "model"; MoE experts
              expert-parallel over "data".

Per-tensor rules (feature dims), the reference's:

* embeddings: the vocabulary over "model".
* FFN: d_ff over "model".
* attention projections: replicated over "model" (the pool's head counts
  mostly do not divide a 16-wide axis; the residual stream is sharded by
  sequence instead, K/V gathered per layer), except in consensus mode,
  where they shard on d_model.
* mamba: d_inner over "model". rwkv: the square projections on their
  output dim (their input dim for ``wo``).
* MoE experts: the expert dim over "model" in replica mode; over "data"
  with the per-expert d_ff over "model" in serve and consensus modes.

The reference matches paths of its own tree (``layers_head/<i>``,
``layers_scan/<j>`` stacked with a leading unsharded ``n_rep`` dim,
``layers_tail/<i>``); the port's tree holds its layers as a plain list
(``layers/<i>``), so each leaf here gets the reference's spec with that
leading dim dropped. The paths' components that the rules read
(``/attn/``, ``/cross/``, ``/moe/``, ``/mamba/``, ``/rwkv/``, ``/ffn/``
and the leaf's name) are the same in both trees.

A mesh is anything with ``axis_names`` and a ``shape`` mapping:
``launch.mesh.make_production_mesh``'s named shapes, the port's process
group ``launch.mesh.Mesh``, or a ``jax.sharding.Mesh``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from ..configs.base import ModelConfig

MODEL_AXIS = "model"


def _canon(part):
    """A dim's entry: None, an axis name, or a tuple of two or more names
    (a tuple of one is its name, as ``jax.sharding.PartitionSpec``
    normalizes it)."""
    if isinstance(part, tuple) and len(part) == 1:
        return part[0]
    return part


class P(tuple):
    """A partition spec: one entry per tensor dimension (trailing dims
    left out are replicated), each None, a mesh axis's name, or a tuple
    of names (the dim split over those axes, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_canon(p) for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axis_size(mesh, axes) -> int:
    axes = axes if isinstance(axes, tuple) else (axes,)
    size = 1
    for a in axes:
        size *= int(mesh.shape[a])
    return size


def agent_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_axes(mesh) -> Tuple[str, ...]:
    return agent_axes(mesh)


def n_agents(mesh) -> int:
    return _axis_size(mesh, agent_axes(mesh))


def _map_with_path(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, its structure
    kept; ``path`` is the "/"-joined keys and indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(map(str, prefix)), tree)


def _leaf_spec(cfg: ModelConfig, path: str, ndim: int, mode: str) -> P:
    """Feature-dim spec of one parameter leaf of rank ``ndim`` (no agent
    axis)."""
    m = MODEL_AXIS

    def pad(*dims):
        return P(*(tuple(dims) + (None,) * (ndim - len(dims))))

    name = path.rsplit("/", 1)[-1]

    if name == "embed":
        return P(m, None)
    if name == "lm_head":
        return P(None, m)
    if name in ("pos_embed", "enc_pos_embed"):
        return P(None, None)

    if "/moe/" in path or path.endswith("moe"):
        if name == "router":
            return P(None, None)
        # serve and consensus hold ONE copy of the expert bank: experts
        # over "data", each expert's d_ff over "model"; a replica's own
        # bank has its experts over "model"
        ep = mode in ("serve", "consensus")
        expert_axis = "data" if ep else m
        if name in ("w_gate", "w_up"):                  # (E, D, F)
            return P(expert_axis, None, m if ep else None)
        if name == "w_down":                            # (E, F, D)
            return P(expert_axis, m if ep else None, None)

    if "/mamba/" in path:
        if name in ("in_x", "in_z", "conv_w", "dt_proj"):
            return P(None, m)
        if name in ("conv_b", "D", "dt_bias"):
            return P(m)
        if name in ("x_proj", "A_log", "out_proj"):
            return P(m, None)

    if "/rwkv/" in path:
        if name in ("wr", "wk", "wv", "wg"):
            return P(None, m)
        if name == "wo":
            return P(m, None)
        return pad()                                    # loras, mixes, norms

    if cfg.rwkv and "/ffn/" in path:                    # rwkv channel mix
        if name == "wk":                                # (D, F)
            return P(None, m)
        if name == "wv":                                # (F, D)
            return P(m, None)
        if name == "wr":                                # (D, D)
            return P(None, None)
        return pad()

    if "/ffn/" in path:
        if name in ("w_gate", "w_up", "w_in"):
            return P(None, m)
        if name in ("w_down", "w_out"):
            return P(m, None)
        if name == "b_in":
            return P(m)
        return pad()

    if "/attn/" in path or "/cross/" in path:
        # heads are not sharded; consensus shards the projections on
        # d_model, the other modes replicate them
        if mode == "consensus":
            if name in ("wq", "wk", "wv"):              # (D, H, hd)
                return P(m, None, None)
            if name == "wo":                            # (H, hd, D)
                return P(None, m, None)
        return pad()

    return pad()                                        # norms, scalars


def guard_divisibility(spec: P, shape, mesh) -> P:
    """Drop the sharding of dims that their mesh axes do not divide (e.g.
    whisper's 51865-word vocabulary over a 16-wide model axis: that dim
    is replicated)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(None if axp is None or int(d) % _axis_size(mesh, axp)
               else axp
               for d, axp in zip(shape, parts, strict=False)))


def param_pspecs(cfg: ModelConfig, params_tree: Any, mode: str,
                 mesh) -> Any:
    """A spec tree matching ``params_tree`` (meta or real tensors, or
    anything with a ``shape``); in replica mode every leaf has the agent
    axis leading."""
    stacked = mode == "replica"
    ax = agent_axes(mesh)

    def fn(path, leaf):
        nd = len(leaf.shape) - (1 if stacked else 0)
        spec = _leaf_spec(cfg, path, nd, mode)
        prefix = (ax,) if stacked else ()
        return guard_divisibility(P(*prefix, *spec), leaf.shape, mesh)

    return _map_with_path(fn, params_tree)


# ---------------------------------------------------------------------------
# batch, cache and activation specs
# ---------------------------------------------------------------------------

def train_batch_pspecs(cfg: ModelConfig, batch_tree: Any, mode: str,
                       mesh) -> Any:
    """Train batches are (N_agents, per_agent, ...) in replica mode, the
    agents over the agent axes, and (N_pop, microbatch, ...) in consensus
    mode, the population walked in turn and each microbatch over the
    data axes."""
    ax = agent_axes(mesh)

    def fn(path, leaf):
        nd = len(leaf.shape)
        if mode == "replica":
            return P(ax, *(None,) * (nd - 1))
        return P(None, ax, *(None,) * (nd - 2))

    return _map_with_path(fn, batch_tree)


def serve_batch_pspecs(cfg: ModelConfig, batch_tree: Any, mesh,
                       batch_size: int) -> Any:
    ax = data_axes(mesh)
    shard_batch = batch_size % _axis_size(mesh, ax) == 0

    def fn(path, leaf):
        nd = len(leaf.shape)
        if shard_batch:
            return P(ax, *(None,) * (nd - 1))
        return P(*(None,) * nd)

    return _map_with_path(fn, batch_tree)


def cache_pspecs(cfg: ModelConfig, cache_tree: Any, mesh,
                 batch_size: int) -> Any:
    """Decode-cache specs (the port's cache: a list of per-layer entries,
    and an encoder-decoder's ``enc_out``). The batch over the data axes
    when they divide it; the cache's sequence dim over "model" (B > 1 of
    them) or over every axis (B = 1, long context)."""
    ax = data_axes(mesh)
    shard_batch = batch_size % _axis_size(mesh, ax) == 0
    seq_axes: Any = MODEL_AXIS if shard_batch else tuple(ax) + (MODEL_AXIS,)
    batch_spec = ax if shard_batch else None

    def fn(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = len(leaf.shape)
        if name in ("k", "v"):             # (B, L, kv, hd)
            spec = P(batch_spec, seq_axes, None, None)
        elif name == "h":                  # mamba state (B, di, ds)
            spec = P(batch_spec, MODEL_AXIS, None)
        elif name == "conv":               # (B, K − 1, di)
            spec = P(batch_spec, None, MODEL_AXIS)
        elif name == "s":                  # rwkv state (B, H, n, n)
            spec = P(batch_spec, MODEL_AXIS, None, None)
        elif name in ("x_prev", "channel_x_prev"):
            spec = P(batch_spec, None, None)
        elif name == "enc_out":            # (B, T, D)
            spec = P(batch_spec, None, None)
        else:
            spec = P(batch_spec, *(None,) * (nd - 1))
        return guard_divisibility(spec, leaf.shape, mesh)

    return _map_with_path(fn, cache_tree)


def activation_roles(cfg: ModelConfig, mode: str, mesh,
                     kind: str) -> Dict[str, P]:
    """Role specs for ``context.maybe_constrain``.

    Train and prefill on attention-only archs: the residual stream is
    sharded by sequence over "model" (context parallelism), K/V gathered
    per layer ("kv_full"). SSM and hybrid archs, and encoder-decoders,
    keep the sequence whole. Outside consensus mode the dense FFN gathers
    its input ("ffn_input") and returns to the sequence-sharded residual.
    Replica-mode specs describe one agent's (b, S, D) ranks; decode has
    no roles."""
    if kind == "decode":
        return {}
    has_ssm = any(ls.mixer in ("mamba", "rwkv") for ls in cfg.layer_specs())
    seq_shardable = not has_ssm and not cfg.is_encoder_decoder
    if mode == "replica":
        lead: Tuple = (None,)
    else:                       # consensus: microbatch; serve: the batch
        lead = (agent_axes(mesh),)
    roles: Dict[str, P] = {}
    if seq_shardable:
        roles["residual"] = P(*lead, MODEL_AXIS, None)
        roles["kv_full"] = P(*lead, None, None, None)
        if mode != "consensus":
            roles["ffn_input"] = P(*lead, None, None)
    else:
        roles["residual"] = P(*lead, None, None)
    return roles


# ---------------------------------------------------------------------------
# specs → torch.distributed.tensor placements
# ---------------------------------------------------------------------------

def to_placements(spec, device_mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` over
    ``device_mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``), one per
    mesh dim: ``Shard(d)`` where tensor dim d names that mesh axis,
    ``Replicate()`` elsewhere. A dim split over several axes names them
    in the mesh's order (DTensor splits a dim over its mesh dims in that
    order, major first, as the spec means)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names or ())
    owner: Dict[str, int] = {}
    for d, part in enumerate(P(*spec)):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {P(*spec)} names axes {unknown} not in "
                             f"the mesh's {names}")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {P(*spec)}: dim {d} is split over "
                             f"{axes}, not in the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {P(*spec)} shards dims {owner[a]} "
                                 f"and {d} over the one axis {a!r}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)
