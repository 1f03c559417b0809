"""Carry state across from the JAX reference, given as numpy arrays.

The reference draws θ⁽⁰⁾ with ``init_state(PRNGKey(seed), n, dim,
init_fn=policy.init)``, and LM weights with ``transformer.init_params``;
the port's generators give other numbers, so a comparison starts both
packages from the reference's state through here. The reference's threefry
keys have no counterpart anywhere: the port's states get fresh generators,
and a comparison injects the reference's draws.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ._device import resolve_device
from .checkpoint.io import path_key
from .comm.channel import ChannelState
from .configs.base import ModelConfig
from .core.netes import NetESState
from .core.topology_repr import Topology
from .core.topology_sched import ScheduleState, TopologySchedule
from .core.tree import flatten, leaf_paths, tree_map
from .obs.probes import MetricsState
from .models.transformer import check_ported, stack_plan


def state_from_reference(thetas, best_theta, best_reward, step, *,
                         seed: int = 0,
                         device: Union[str, torch.device] = "cuda"
                         ) -> NetESState:
    """The reference's ``NetESState`` leaves → the port's state. The PRNG
    key has no counterpart: the state gets a fresh generator seeded with
    ``seed`` (draws are injected where trajectories must match)."""
    dev = resolve_device(device)
    return NetESState(
        thetas=torch.as_tensor(np.array(thetas, np.float32), device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        step=torch.as_tensor(np.array(step, np.int32), device=dev),
        best_reward=torch.as_tensor(np.array(best_reward, np.float32),
                                    device=dev),
        best_theta=torch.as_tensor(np.array(best_theta, np.float32),
                                   device=dev))


def state_from_reference_npz(path: Union[str, pathlib.Path],
                             prefix: str = "netes", *, seed: int = 0,
                             device: Union[str, torch.device] = "cuda"
                             ) -> NetESState:
    """The NetES state in a checkpoint the reference wrote
    (``repro.checkpoint.save_pytree``/``save_train_state``), stored under
    ``prefix``: its leaves ``.thetas``, ``.step``, ``.best_reward`` and
    ``.best_theta``, read by the keys both packages use
    (``checkpoint.io.path_key``). The ``.key`` leaf, a threefry key, has no
    counterpart and is skipped: the state gets a fresh generator seeded
    with ``seed``, as in :func:`state_from_reference`."""
    with np.load(path, allow_pickle=False) as data:
        leaves = {f: data[path_key((prefix, "." + f))] for f in
                  ("thetas", "best_theta", "best_reward", "step")}
    return state_from_reference(**leaves, seed=seed, device=device)


def topology_from_reference(kind: str, n: int, deg, *, adj=None,
                            neighbor_idx=None, neighbor_mask=None,
                            offsets: Optional[Sequence[int]] = None,
                            shifts: Optional[Sequence[int]] = None,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Topology:
    """The reference ``Topology``'s leaves → the port's ``Topology``. A
    circulant has its static ``offsets`` or, scheduled, its ``shifts`` (the
    reference's traced int32 array, read here into host ints)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.array(a, dtype),
                                                      device=dev)

    if kind == "circulant" and (offsets is None) == (shifts is None):
        raise ValueError("a circulant topology needs its offsets or its "
                         "shifts")
    return Topology(kind=kind, n=n, deg=t(deg, np.float32),
                    adj=t(adj, np.float32),
                    neighbor_idx=t(neighbor_idx, np.int32),
                    neighbor_mask=t(neighbor_mask, np.float32),
                    offsets=None if offsets is None else tuple(offsets),
                    shifts=(None if shifts is None
                            else tuple(int(d) for d in np.asarray(shifts))))


def schedule_state_from_reference(schedule: TopologySchedule,
                                  topo: Topology, t: int, u=None
                                  ) -> ScheduleState:
    """The reference's ``ScheduleState`` → the port's, for ``schedule``:
    the topology in force (from :func:`topology_from_reference`), the
    iteration ``t``, and for ``anneal_density`` the fixed (N, N) uniform
    ``u`` its graphs are thresholds of (``jax.random.uniform(
    PRNGKey(spec.seed), (n, n))``). The threefry key has no counterpart:
    ``resample_er`` gets a fresh generator seeded with ``spec.seed``, so a
    comparison injects the reference's redraws."""
    kind = schedule.spec.kind
    if (u is None) != (kind != "anneal_density"):
        raise ValueError("anneal_density needs its uniform u, and only it")
    dev = topo.device
    gen = None
    if kind == "resample_er":
        gen = torch.Generator(device=dev).manual_seed(schedule.spec.seed)
    return ScheduleState(
        topo=topo, t=int(t), generator=gen,
        u=None if u is None else torch.as_tensor(np.array(u, np.float32),
                                                 device=dev))


def channel_state_from_reference(last_sent, msgs, *, seed: int = 0,
                                 draws: int = 0,
                                 device: Union[str, torch.device] = "cuda"
                                 ) -> ChannelState:
    """The reference's ``ChannelState`` leaves → the port's state.
    ``last_sent`` is the payload-shaped array, or None (the reference's
    ``()``) without an event stage; ``msgs`` the cumulative count. The
    threefry key has no counterpart: the port's dropout PRF is keyed by
    ``seed`` (the dropout stage's seed) and the count ``draws`` of masks
    drawn so far, so the port draws other masks than the reference from
    here on; a comparison injects the reference's masks
    (``core.netes.Draws.edge_mask``)."""
    dev = resolve_device(device)
    has_last = last_sent is not None and np.size(last_sent) > 0
    return ChannelState(
        seed=torch.tensor(seed, dtype=torch.int64, device=dev),
        draws=torch.tensor(draws, dtype=torch.int64, device=dev),
        last_sent=(torch.as_tensor(np.array(last_sent, np.float32),
                                   device=dev) if has_last else None),
        msgs=torch.as_tensor(np.array(msgs, np.float32), device=dev))


def metrics_state_from_reference(buf, cursor, *,
                                 device: Union[str, torch.device] = "cuda"
                                 ) -> MetricsState:
    """The reference's probe ring (``repro.obs.probes.MetricsState``: ``buf``
    (S, capacity) float32, ``cursor`` () int32) → the port's, on
    ``device``. The leaves carry across bit for bit; the port's checkpoint
    keeps them under the same keys (``obs::.buf``, ``obs::.cursor``)."""
    dev = resolve_device(device)
    return MetricsState(
        buf=torch.as_tensor(np.array(buf, np.float32), device=dev),
        cursor=torch.as_tensor(np.array(cursor, np.int32), device=dev))


def _nest(flat: Mapping[str, Any], prefix: str, index: Optional[int],
          dev: torch.device) -> Dict[str, Any]:
    """The subtree of ``flat`` under ``prefix`` as nested dicts of tensors;
    with ``index``, each leaf's slice ``[index]`` of its stacked axis."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = np.asarray(arr)
        node[leaf] = torch.as_tensor(a if index is None else a[index],
                                     device=dev).contiguous()
    return tree


def lm_params_from_reference(flat: Mapping[str, Any], cfg: ModelConfig, *,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Dict[str, Any]:
    """The reference's ``transformer.init_params`` pytree → the port's
    parameters.

    ``flat`` maps each leaf's path, its dict keys and list indices joined
    by "/", to a numpy array: ``embed``, ``final_norm/scale``,
    ``layers_head/<i>/attn/wq``, ``layers_scan/<j>/ffn/w_up``, … . The
    reference lays the layers out as ``stack_plan`` says: ``layers_head``
    unrolled, then ``layers_scan``, one entry per layer of the scanned
    period with every leaf stacked on a leading axis of its ``n_rep``
    repetitions (a 40-layer uniform stack is one period of one layer, 40
    times), then ``layers_tail``. They are unstacked here into the port's
    plain list in layer order. Each weight keeps the reference's layout:
    ``wq``/``wk``/``wv`` (d, heads, head_dim), ``wo`` (heads, head_dim, d),
    the MLP matrices (d_in, d_out), ``embed`` (vocab, d), an MoE
    layer's ``moe/router`` (d, E), ``moe/w_gate``/``w_up`` (E, d, d_ff)
    and ``moe/w_down`` (E, d_ff, d), and an rwkv layer's ``rwkv/…`` time
    mix (``mix`` (5, d), ``wr``…``wo`` (d, d), ``mix_lora``/``decay_lora``
    ``a``, ``b``, ``bias``, ``decay_base`` (d,), ``bonus_u`` (H, n),
    ``ln_x``) and ``ffn/…`` channel mix (``mix_k``, ``mix_r``, ``wk``,
    ``wv``, ``wr``), and a mamba layer's ``mamba/…`` mixer (``in_x``,
    ``in_z`` (d, d_inner), ``conv_w`` (d_conv, d_inner), ``conv_b``
    (d_inner,), ``x_proj`` (d_inner, dt_rank + 2·d_state), ``dt_proj``
    (dt_rank, d_inner), ``dt_bias`` and ``D`` (d_inner,), ``A_log``
    (d_inner, d_state), ``out_proj`` (d_inner, d)). A hybrid stack such as
    jamba's scans a period of several layers (plan (0, 8, 4, 0) at 32
    layers: ``layers_scan/0`` … ``layers_scan/7``, each stacked 4 times).
    Learned positions are ``pos_embed`` (max_position, d); an
    encoder-decoder's decoder layers each hold ``cross/…`` (an attention
    block) and ``norm_cross``, and its encoder is ``enc_layers/<i>/…``
    (a plain list, never stacked), ``enc_norm`` and ``enc_pos_embed``
    (encoder_seq, d). A key of ``flat`` that none of these take raises.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    head, period, n_rep, tail = stack_plan(cfg)
    if n_rep == 1:
        head, period, tail = cfg.num_layers, 0, 0
    prefixes = ([f"layers_head/{i}" for i in range(head)]
                + [f"layers_scan/{j}" for j in range(period)]
                + [f"layers_tail/{i}" for i in range(tail)])
    layers = [_nest(flat, f"layers_head/{i}", None, dev) for i in range(head)]
    layers += [_nest(flat, f"layers_scan/{j}", r, dev)
               for r in range(n_rep) for j in range(period)]
    layers += [_nest(flat, f"layers_tail/{i}", None, dev) for i in range(tail)]
    enc = [f"enc_layers/{i}" for i in range(cfg.encoder_layers)]
    whole = [k for k in _LM_ARRAYS if k in flat]
    nested = prefixes + enc + [k for k in _LM_NORMS if k + "/scale" in flat]
    stray = [k for k in flat if k not in whole
             and not any(k.startswith(p + "/") for p in nested)]
    if len(layers) != cfg.num_layers or not all(layers) or stray:
        raise ValueError(f"the reference parameters are not the "
                         f"{cfg.num_layers} layers of {cfg.name} laid out as "
                         f"stack_plan {stack_plan(cfg)} says (stray: {stray})")
    params: Dict[str, Any] = {
        k: torch.as_tensor(np.asarray(flat[k]), device=dev) for k in whole}
    params.update({k: _nest(flat, k, None, dev) for k in _LM_NORMS
                   if k + "/scale" in flat})
    params["layers"] = layers
    if enc:
        params["enc_layers"] = [_nest(flat, p, None, dev) for p in enc]
    return params


# the top-level leaves of an LM's parameter tree besides its layers: whole
# arrays, and norms (a dict of ``scale`` and, for a LayerNorm, ``bias``)
_LM_ARRAYS = ("embed", "pos_embed", "enc_pos_embed")
_LM_NORMS = ("final_norm", "enc_norm")


def _flat_leaves(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """``tree``'s leaves into ``out`` as numpy arrays under "/"-joined
    keys below ``prefix``."""
    for path, leaf in zip(leaf_paths(tree), flatten(tree), strict=True):
        out["/".join((prefix, *map(str, path)))] = (leaf.detach().cpu()
                                                    .numpy())


def lm_params_to_reference(params: Mapping[str, Any],
                           cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`lm_params_from_reference`: the port's
    parameters → the reference's flat layout (``layers_head/<i>/...``,
    ``layers_scan/<j>/...`` stacked over the ``n_rep`` repetitions,
    ``layers_tail/<i>/...``, as ``stack_plan`` says), as numpy arrays."""
    check_ported(cfg)
    head, period, n_rep, tail = stack_plan(cfg)
    if n_rep == 1:
        head, period, tail = cfg.num_layers, 0, 0
    layers = params["layers"]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers, {cfg.name} has "
                         f"{cfg.num_layers}")
    flat: Dict[str, np.ndarray] = {k: params[k].detach().cpu().numpy()
                                   for k in _LM_ARRAYS if k in params}
    for k in _LM_NORMS:
        if k in params:
            _flat_leaves(params[k], k, flat)
    for i, lay in enumerate(params.get("enc_layers", ())):
        _flat_leaves(lay, f"enc_layers/{i}", flat)
    for i in range(head):
        _flat_leaves(layers[i], f"layers_head/{i}", flat)
    for j in range(period):
        reps: Dict[str, list] = {}
        for r in range(n_rep):
            one: Dict[str, np.ndarray] = {}
            _flat_leaves(layers[head + r * period + j], f"layers_scan/{j}",
                         one)
            for k, a in one.items():
                reps.setdefault(k, []).append(a)
        flat.update({k: np.stack(a) for k, a in reps.items()})
    for i in range(tail):
        _flat_leaves(layers[head + n_rep * period + i], f"layers_tail/{i}",
                     flat)
    return flat


def lm_population_from_reference(flat: Mapping[str, Any], cfg: ModelConfig,
                                 *, device: Union[str, torch.device] = "cuda"
                                 ) -> Dict[str, Any]:
    """The reference's replica-step parameters (every leaf of its
    ``init_params`` tree with a leading agent axis N, the layers laid out
    as ``stack_plan`` says) → the port's population: the port's tree
    (``lm_params_from_reference`` of each agent) with the agent axis
    leading every leaf, as ``distributed.netes_dist`` takes it."""
    n = len(np.asarray(flat["embed"]))
    agents = [lm_params_from_reference({k: np.asarray(a)[i]
                                        for k, a in flat.items()},
                                       cfg, device="cpu")
              for i in range(n)]
    dev = resolve_device(device)
    return tree_map(lambda *leaves: torch.stack(leaves).to(dev), *agents)


def lm_population_to_reference(params: Mapping[str, Any],
                               cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`lm_population_from_reference`: the port's
    population → the reference's flat layout with the agent axis leading
    every leaf."""
    n = params["embed"].shape[0]
    per_agent = [lm_params_to_reference(
                     tree_map(lambda leaf, i=i: leaf[i], params), cfg)
                 for i in range(n)]
    return {k: np.stack([p[k] for p in per_agent]) for k in per_agent[0]}
