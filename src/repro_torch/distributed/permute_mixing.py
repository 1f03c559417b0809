"""θ-mixing for CIRCULANT topologies by a chain of point-to-point hops
(DESIGN.md §2): the port of ``repro.distributed.permute_mixing``.

For a general Erdős–Rényi adjacency the mixing needs an all-gather: every
rank receives all N agents' rows (N·D elements) though a density-p graph
USES only p·N of them. A circulant graph with offset set Δ makes the
neighborhoods uniform:

    mixed_j = Σ_{d ∈ ±Δ ∪ {0}} w_j,(j+d) · θ_{j+d}

so the mixing becomes |±Δ| ring rotations of the local θ with a weighted
accumulation: p·N·D elements moved, a 1/p saving.

One agent a rank, as the reference (one agent a device): the mixers below
take the (N, N) weights, the same on every rank, and this rank's θ
(1, D), and return this rank's mixed row (1, D). Each hop is one
``batch_isend_irecv`` of the collective layer of
``distributed.fleet_shard`` (``_ShardOps.ppermute_recv``). Nothing here
runs a kernel, and no training path calls it: it is the wire-format study
of DESIGN.md §2, held against ``circulant_mixing_ref``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.topology_repr import Topology, signed_offsets
from .fleet_shard import _ShardOps


def _wire_codec(channel):
    """A ``comm.channel.Channel`` as the per-rank payload encoder applied
    BEFORE the collective (DESIGN.md §11): each rank compresses its θ row
    once and every hop moves the encoded payload. Only stateless
    compression belongs at this layer; event triggers and edge dropout
    live in the step builders."""
    if channel is None or channel.lossless:
        return lambda x: x
    if not channel.collective_eligible:
        raise ValueError(
            "collective-layer channels carry only stateless payload "
            "codecs (quantize/topk); event_triggered and dropout stages "
            "thread through the train-step builders instead")
    return lambda x: channel.codec(x, batched=True)


def circulant_mixing_ref(weights: torch.Tensor, thetas: torch.Tensor,
                         offsets: Sequence[int]) -> torch.Tensor:
    """Oracle: mixed_j = Σ_d w[j, (j+d)%N]·θ_{(j+d)%N}, d ∈ ±Δ ∪ {0}.

    weights (N, N) dense mixing weights (e.g. adj · R̃); thetas (N, D).
    Only the circulant-neighborhood entries of ``weights`` are read."""
    n = thetas.shape[0]
    idx = torch.arange(n, device=thetas.device)
    acc = weights[idx, idx][:, None] * thetas
    for d in signed_offsets(offsets, n):
        src = (idx + d) % n
        acc = acc + weights[idx, src][:, None] * thetas[src]
    return acc


def _chain(ops: _ShardOps, rank: int, n: int, shifts, weights, theta,
           encode):
    """The hop chain of one offset set: rotate the ring by d − (previous
    d) each hop, so rank j holds rank (j + d)'s encoded row after it."""
    recv = encode(theta)
    acc = weights[rank, rank] * recv
    prev = 0
    for d in shifts:
        recv = ops.ppermute_recv(recv, (d - prev) % n)
        prev = d
        acc = acc + weights[rank, (rank + d) % n] * recv
    return acc


def make_permute_mixing(mesh, offsets: Sequence[int], channel=None):
    """``mix(weights (N, N), theta (1, D)) -> (1, D)`` over the ranks of
    ``mesh`` (N = its world size), moving p·N·D elements by a chain of
    hops instead of an N·D all-gather. ``channel`` encodes each rank's θ
    ONCE before it enters the ring; the self term reads the encoded value
    too, as every consumer of the payload does in the core engine."""
    n = mesh.world_size
    shifts = signed_offsets(offsets, n)
    encode = _wire_codec(channel)
    ops = _ShardOps(mesh)

    def mix(weights: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        return _chain(ops, mesh.rank, n, shifts, weights, theta, encode)

    return mix


def make_allgather_mixing(mesh, channel=None):
    """Dense backend: one all-gather of θ (N·D elements), then the local
    row's contraction. Every rank (j included) contracts the SAME encoded
    values, so receivers never diverge."""
    encode = _wire_codec(channel)
    ops = _ShardOps(mesh)

    def mix(weights: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        full = ops.all_gather(encode(theta))                    # (N, D)
        return (weights[mesh.rank] @ full)[None]

    return mix


def make_sparse_gather_mixing(mesh, topo: Topology, channel=None):
    """Sparse backend: all-gather θ, then contract ONLY the K_max listed
    neighbors: O(K·D) local work instead of O(N·D). ``weights`` is the
    full mixing matrix (adj ⊙ R̃), so only the padding indicator of
    ``neighbor_mask`` applies here."""
    idx, mask = topo.neighbor_idx, topo.neighbor_mask
    encode = _wire_codec(channel)
    ops = _ShardOps(mesh)

    def mix(weights: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        j = mesh.rank
        full = ops.all_gather(encode(theta))                    # (N, D)
        cols = idx[j].long()
        valid = (mask[j] != 0).to(weights.dtype)
        w = weights[j, cols] * valid                            # (K,)
        return (w @ full[cols])[None]

    return mix


def make_topology_mixing(mesh, topo: Topology, channel=None):
    """The mixing backend of the topology's representation: the hop chain
    for a circulant, the gather-then-contract for sparse and dense."""
    if topo.kind == "circulant":
        return make_permute_mixing(mesh, topo.offsets, channel=channel)
    if topo.kind == "sparse":
        return make_sparse_gather_mixing(mesh, topo, channel=channel)
    return make_allgather_mixing(mesh, channel=channel)


def make_rotating_permute_mixing(mesh, offsets: Sequence[int], stride: int,
                                 channel=None):
    """Rotating-circulant backend: ``mix(weights, theta, t) -> (1, D)``.

    The ``rotate_circulant`` schedule maps offset d to ((d − 1 + t·stride)
    mod m) + 1 with m = (n − 1)//2, so the offset sets cycle with period
    m / gcd(stride, m). Phase ``t mod cycle`` picks its chain; ``t`` is a
    host int, the same on every rank, so all ranks run the same hops."""
    n = mesh.world_size
    m = max(1, (n - 1) // 2)
    if offsets and max(offsets) > m:
        raise ValueError(f"rotating offsets must lie in [1, {m}] (n={n})")
    cycle = m // math.gcd(stride % m or m, m)
    encode = _wire_codec(channel)
    ops = _ShardOps(mesh)
    phases = [signed_offsets([(d - 1 + c * stride) % m + 1
                              for d in offsets], n) for c in range(cycle)]

    def mix(weights: torch.Tensor, theta: torch.Tensor,
            t: int) -> torch.Tensor:
        return _chain(ops, mesh.rank, n, phases[int(t) % cycle], weights,
                      theta, encode)

    return mix


# ---------------------------------------------------------------------------
# contract-linter registry hook (repro_torch.analysis)
# ---------------------------------------------------------------------------

def analysis_entry_points():
    """Contract-linter entry points for the permute mixers, one agent a
    rank. The rotating mixer picks its hop chain by a host phase; the
    rank-collective-parity contract runs it on a group of 5 ranks (cycle
    > 1) and holds every rank to the same hops."""
    import torch.distributed as dist

    from ..analysis.registry import EntryPoint
    from ..launch.mesh import Mesh

    def _mesh(device):
        return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    world_size=dist.get_world_size(),
                    device=torch.device(device))

    def _mix_args(n, device, d=16):
        return (torch.ones((n, n), dtype=torch.float32, device=device),
                torch.ones((1, d), dtype=torch.float32, device=device))

    def build_static_chain(device):
        mesh = _mesh(device)
        return (make_permute_mixing(mesh, (1,)),
                _mix_args(mesh.world_size, device), {})

    def build_rotating_switch(device):
        mesh = _mesh(device)
        return (make_rotating_permute_mixing(mesh, (1, 2), stride=1),
                _mix_args(mesh.world_size, device) + (0,), {})

    return (
        EntryPoint(name="permute_mixing.static_chain",
                   build=build_static_chain, min_devices=2),
        EntryPoint(name="permute_mixing.rotating_switch",
                   build=build_rotating_switch, min_devices=5),
    )
