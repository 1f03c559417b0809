"""Physical representations of a topology for the NetES mixing update.

The port of ``repro.core.topology_repr`` (DESIGN.md §3, §12). A ``Topology``
is a dataclass of tensors in one of three representations:

``dense``
    ``adj (N, N)`` float32; mixing runs the dense Eq. 3 kernel
    (``kernels/netes_mixing``).
``sparse``
    Padded neighbor list ``neighbor_idx (N, K_max)`` int32 and
    ``neighbor_mask (N, K_max)`` float32 holding the edge weight a_ji (0 on
    padding; padded slots index row j itself, so every gather stays in
    bounds); mixing runs the sparse Eq. 3 kernel
    (``kernels/netes_sparse_mixing``), or, for a quantizing channel's wire
    form, the fused kernel (``kernels/netes_fused_mixing``).
``circulant``
    Static generator offsets of a symmetric self-looped ring graph; mixing
    is a chain of ``torch.roll``s and needs no kernel. A scheduled
    (rotating) circulant carries its signed ring ``shifts`` instead, host
    ints in the reference's order (``shift_circulant``).

``weighted_neighbor_sum`` and ``weighted_row_sum`` take an optional
``edge_mask`` from a lossy channel (``comm.channel.dropout_mask``), matched
to the representation: dense (N, N), sparse (N, K_max), circulant
(|±Δ|, N). ``weighted_neighbor_sum`` also takes a ``WirePayload``: sparse
graphs contract it with the fused kernel, dense and circulant decode it.

The constructors are host-side numpy, run once at launch, and must agree with
the reference slot for slot (tests/test_torch_topology.py). A fused-eligible
channel raises the sparse cutoff of ``select_representation``. The refresh
functions at the end (``refresh_dense``, ``refresh_sparse``,
``shift_circulant``) are what a topology schedule (``core/topology_sched``)
changes between steps: on the device, with every shape kept. Last,
``widen_sparse``, ``stack`` and ``unstack`` give the candidates of a
topology search's cohort (``search.tournament``) one shared K_max.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from . import topology as topo_gen
from . import wire_format

# Max degree at or below which the neighbor list is preferred over dense
# (the reference's cutoff: past it the padded K_max approaches N).
SPARSE_DENSITY_CUTOFF = 0.25

# The cutoff under a fused-eligible quantizing channel: the fused kernel's
# int8 gathers are 4× narrower than the f32 operands, so denser graphs keep
# the neighbor list (the reference's value).
FUSED_SPARSE_DENSITY_CUTOFF = 0.5

# A circulant roll chain costs one pass per signed offset; past this
# fraction of the ring it stops beating the dense contraction.
CIRCULANT_OFFSET_CUTOFF = 0.25


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication topology with an explicit physical representation.

    Exactly one representation's payload is set: ``adj`` (dense),
    ``neighbor_idx``/``neighbor_mask`` (sparse), or for a circulant its
    generator ``offsets`` or, scheduled, its signed ring ``shifts`` (host
    ints, distinct and nonzero mod N, in the order the roll chain and a
    dropout mask's rows take them). ``deg (N,)`` float32 (row degrees,
    self-loop included) is always set; ``normalization="degree"`` needs it
    whatever the representation.
    """

    kind: str                                       # dense | sparse | circulant
    n: int
    deg: torch.Tensor
    adj: Optional[torch.Tensor] = None              # (N, N)      [dense]
    neighbor_idx: Optional[torch.Tensor] = None     # (N, K_max)  [sparse]
    neighbor_mask: Optional[torch.Tensor] = None    # (N, K_max)  [sparse]
    offsets: Optional[Tuple[int, ...]] = None       # [circulant]
    shifts: Optional[Tuple[int, ...]] = None        # [circulant, scheduled]

    @property
    def k_max(self) -> int:
        return 0 if self.neighbor_idx is None else self.neighbor_idx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.deg.device

    def to_dense(self) -> torch.Tensor:
        """Materialize the (N, N) float32 adjacency."""
        if self.kind == "dense":
            return self.adj
        if self.kind == "circulant":
            # ±d of each shift d: the signed shifts generate the same graph
            gen = self.offsets if self.shifts is None else self.shifts
            return torch.as_tensor(
                topo_gen.circulant_from_offsets(self.n, list(gen)),
                device=self.device)
        # sparse: each (j, i) edge appears once per row and padded slots add
        # weight 0 at (j, j), so the scatter-add is exact.
        n, k = self.neighbor_idx.shape
        rows = torch.arange(n, device=self.device).repeat_interleave(k)
        cols = self.neighbor_idx.reshape(-1).long()
        out = torch.zeros((n, n), dtype=torch.float32, device=self.device)
        return out.index_put_((rows, cols), self.neighbor_mask.reshape(-1),
                              accumulate=True)


# ---------------------------------------------------------------------------
# host-side constructors (numpy, as in the reference)
# ---------------------------------------------------------------------------

def sparse_neighbors(adj: np.ndarray, k_max: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Padded neighbor list from a dense adjacency.

    Returns ``(neighbor_idx (N, K_max) int32, neighbor_mask (N, K_max)
    float32)``: row j lists its neighbors in ascending order (``nonzero``),
    the mask carries ``adj[j, i]``, and padded slots index j with weight 0.
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    degs = (adj != 0).sum(axis=1)
    if k_max is None:
        k_max = max(int(degs.max()), 1)
    elif k_max < int(degs.max()):
        raise ValueError(f"k_max={k_max} < max degree {int(degs.max())}")
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    mask = np.zeros((n, k_max), np.float32)
    for j in range(n):
        nbrs = np.nonzero(adj[j] != 0)[0]
        idx[j, :len(nbrs)] = nbrs
        mask[j, :len(nbrs)] = adj[j, nbrs]
    return idx, mask


def _exact_circulant_offsets(adj: np.ndarray):
    """Offsets iff the graph is exactly the symmetric, self-looped circulant
    they generate (the roll chain adds the self term and both ±d shifts
    with unit weight, so nothing else may take that path)."""
    offs = topo_gen.circulant_offsets(adj)
    if offs is None:
        return None
    rebuilt = topo_gen.circulant_from_offsets(adj.shape[0], offs)
    return offs if np.array_equal(np.asarray(adj, np.float32),
                                  rebuilt) else None


def select_representation(adj: np.ndarray, channel=None) -> str:
    """The cheapest representation a graph admits: circulant if it is an
    exact circulant with few enough signed offsets, sparse if its max
    degree is at most ``SPARSE_DENSITY_CUTOFF``·N, else dense.

    ``channel`` (a ``comm.channel.Channel``, read by duck typing): when it
    is ``fused`` and ``wire_quantized``, the sparse cutoff rises to
    ``FUSED_SPARSE_DENSITY_CUTOFF``."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    offs = _exact_circulant_offsets(adj)
    if offs is not None and n > 2:
        signed = len(offs) * 2 - (1 if n % 2 == 0 and (n // 2) in offs
                                  else 0)
        if signed <= CIRCULANT_OFFSET_CUTOFF * n:
            return "circulant"
    cutoff = SPARSE_DENSITY_CUTOFF
    if (channel is not None and getattr(channel, "fused", False)
            and getattr(channel, "wire_quantized", False)):
        cutoff = FUSED_SPARSE_DENSITY_CUTOFF
    k_max = int((adj != 0).sum(axis=1).max())
    if k_max <= cutoff * n:
        return "sparse"
    return "dense"


def from_dense(adj, representation: str = "auto",
               device: Union[str, torch.device] = "cuda",
               channel=None) -> Topology:
    """Build a ``Topology`` on ``device`` from a dense adjacency.

    ``representation`` ∈ {auto, dense, sparse, circulant}; ``auto`` runs
    ``select_representation`` (with ``channel``, see there); ``circulant``
    on a non-circulant graph raises.
    """
    dev = resolve_device(device)
    adj_np = np.asarray(adj, dtype=np.float32)
    n = adj_np.shape[0]
    deg = torch.as_tensor(adj_np.sum(axis=1), device=dev)
    if representation == "auto":
        representation = select_representation(adj_np, channel=channel)
    if representation == "dense":
        return Topology(kind="dense", n=n, deg=deg,
                        adj=torch.as_tensor(adj_np, device=dev))
    if representation == "sparse":
        idx, mask = sparse_neighbors(adj_np)
        return Topology(kind="sparse", n=n, deg=deg,
                        neighbor_idx=torch.as_tensor(idx, device=dev),
                        neighbor_mask=torch.as_tensor(mask, device=dev))
    if representation == "circulant":
        offs = _exact_circulant_offsets(adj_np)
        if offs is None:
            raise ValueError(
                "adjacency is not a symmetric self-looped circulant")
        return Topology(kind="circulant", n=n, deg=deg, offsets=tuple(offs))
    raise ValueError(f"unknown representation {representation!r}")


def from_spec(spec: topo_gen.TopologySpec, representation: str = "auto",
              device: Union[str, torch.device] = "cuda",
              channel=None) -> Topology:
    """TopologySpec → generated graph → representation-selected Topology."""
    return from_dense(spec.build(), representation=representation,
                      device=device, channel=channel)


def as_topology(t: Union[Topology, torch.Tensor, np.ndarray],
                device: Union[str, torch.device] = "cuda") -> Topology:
    """Coerce a raw (N, N) adjacency to a dense ``Topology``; a
    ``Topology`` passes through unchanged."""
    if isinstance(t, Topology):
        return t
    adj = torch.as_tensor(t, dtype=torch.float32,
                          device=resolve_device(device))
    return Topology(kind="dense", n=adj.shape[0], deg=adj.sum(dim=1),
                    adj=adj)


# ---------------------------------------------------------------------------
# representation-dispatched primitives (plain PyTorch)
# ---------------------------------------------------------------------------

def signed_offsets(offsets: Sequence[int], n: int):
    """±Δ as distinct nonzero shifts mod n (offset n/2 is self-paired)."""
    out = []
    for d in offsets:
        out.append(d % n)
        if (-d) % n != d % n:
            out.append((-d) % n)
    return sorted(set(out) - {0})


def circulant_shifts(topo: Topology):
    """The ring shifts of a circulant topology's roll chain: its scheduled
    ``shifts`` as they are, else ±Δ of its offsets."""
    if topo.shifts is not None:
        return list(topo.shifts)
    return signed_offsets(topo.offsets, topo.n)


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) → (N, 1, ..., 1) to broadcast against an (N, ...) operand."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def weighted_neighbor_sum(topo: Topology, coeff: torch.Tensor, values,
                          edge_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``out_j = Σ_i a_ji · em_ji · coeff_i · values_i`` — the Eq. 3
    contraction.

    ``coeff (N,)``, ``values (N, ...)`` → ``(N, ...)``: one matmul (dense),
    a K_max-slot gather-accumulate (sparse) or a chain of rolls
    (circulant). ``values`` may be a ``WirePayload`` (see
    ``_wire_neighbor_sum``). ``edge_mask`` drops links as if a_ji were 0
    this step; it multiplies the adjacency (dense), the slot weights before
    ``coeff`` (sparse) or each shifted term (circulant), as the reference.
    """
    if isinstance(values, wire_format.WirePayload):
        return _wire_neighbor_sum(topo, coeff, values, edge_mask)
    src = _col(coeff.to(values.dtype), values.ndim) * values
    if topo.kind == "dense":
        adj = topo.adj if edge_mask is None else topo.adj * edge_mask
        flat = src.reshape(topo.n, -1)
        return (adj.to(values.dtype) @ flat).reshape(values.shape)
    if topo.kind == "circulant":
        acc = src  # d = 0 (self-loop)
        for k, d in enumerate(circulant_shifts(topo)):
            term = torch.roll(src, -d, dims=0)
            if edge_mask is not None:
                term = term * _col(edge_mask[k].to(values.dtype), values.ndim)
            acc = acc + term
        return acc
    idx = topo.neighbor_idx.long()
    mask = (topo.neighbor_mask if edge_mask is None
            else topo.neighbor_mask * edge_mask)
    wnb = (mask * coeff[idx]).to(values.dtype)                  # (N, K)
    acc = torch.zeros_like(values)
    for c in range(idx.shape[1]):
        acc = acc + _col(wnb[:, c], values.ndim) * values[idx[:, c]]
    return acc


def _wire_neighbor_sum(topo: Topology, coeff: torch.Tensor,
                       wp: wire_format.WirePayload,
                       edge_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The wire-form case of ``weighted_neighbor_sum``. Sparse: the int8
    codes and per-source scales go straight to the fused kernel (trailing
    payload dims flatten to one D axis). Dense and circulant decode once
    and recurse: they build no per-edge gather to fuse away."""
    if topo.kind != "sparse":
        return weighted_neighbor_sum(topo, coeff,
                                     wire_format.decode_payload(wp),
                                     edge_mask=edge_mask)
    # imported here: the kernels' plain versions import this module
    from ..kernels.netes_fused_mixing import fused_neighbor_sum
    n = wp.codes.shape[0]
    out = fused_neighbor_sum(topo.neighbor_idx, topo.neighbor_mask, coeff,
                             wp.codes.reshape(n, -1), wp.scale.reshape(n, -1),
                             edge_mask)
    return out.reshape(wp.codes.shape).to(wp.dtype)


def neighbor_column(topo: Topology, i: int,
                    edge_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Column i of the adjacency, ``a_:,i`` as an (N,) float32 vector,
    from the live representation in O(N + K): the weights with which
    every receiver hears source i. Relies on symmetry (column i ≡ row i),
    which every generator guarantees. ``edge_mask`` drops links; it must
    be link-symmetric (``comm.channel.dropout_mask`` is), so that row i's
    mask entries stand for column i's."""
    if topo.kind == "dense":
        col = topo.adj[:, i]
        return col if edge_mask is None else col * edge_mask[:, i]
    if topo.kind == "circulant":
        col = torch.zeros(topo.n, dtype=torch.float32, device=topo.device)
        col[i] = 1.0
        shifts = circulant_shifts(topo)
        if not shifts:
            return col
        # receivers r = (i + d) mod n hear source i over the undirected
        # link {i, r}, whose mask is row k's entry at receiver i
        rs = torch.tensor([(i + d) % topo.n for d in shifts],
                          device=topo.device)
        w = (torch.ones(len(shifts), device=topo.device) if edge_mask is None
             else edge_mask[:, i])
        return col.index_add(0, rs, w)
    mask_row = topo.neighbor_mask[i]
    if edge_mask is not None:
        mask_row = mask_row * edge_mask[i]
    return torch.zeros(topo.n, dtype=torch.float32,
                       device=topo.device).index_add(
        0, topo.neighbor_idx[i].long(), mask_row)


def weighted_row_sum(topo: Topology, coeff: torch.Tensor,
                     edge_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``Σ_i a_ji · em_ji · coeff_i`` per row j — Eq. 3's self-correction
    weight. ``edge_mask`` must be the one the neighbor sum saw."""
    if topo.kind == "dense":
        adj = topo.adj if edge_mask is None else topo.adj * edge_mask
        return adj @ coeff
    if topo.kind == "circulant":
        acc = coeff
        for k, d in enumerate(circulant_shifts(topo)):
            term = torch.roll(coeff, -d)
            if edge_mask is not None:
                term = term * edge_mask[k]
            acc = acc + term
        return acc
    mask = (topo.neighbor_mask if edge_mask is None
            else topo.neighbor_mask * edge_mask)
    return (mask * coeff[topo.neighbor_idx.long()]).sum(dim=1)


# ---------------------------------------------------------------------------
# refresh in place (the topology-schedule paths)
# ---------------------------------------------------------------------------
#
# A schedule keeps every tensor shape: a dense refresh swaps the (N, N)
# adjacency, a sparse one re-pads to the SAME K_max, a rotating circulant
# swaps its host-side shifts.

def refresh_dense(topo: Topology, adj: torch.Tensor) -> Topology:
    """A new dense adjacency, degrees recomputed on its device."""
    return dataclasses.replace(topo, adj=adj, deg=adj.sum(dim=1))


def refresh_sparse(topo: Topology, adj: torch.Tensor) -> Topology:
    """The neighbor list of a new (N, N) adjacency, padded to the existing
    ``k_max``: the reference's ``lax.top_k(adj, k_max)`` per row.

    ``top_k`` gives ties to the lower index; a stable descending sort does
    the same, so on a binary graph a row lists its neighbors in ascending
    order and then, with weight 0, its lowest non-neighbors. A row with
    more than ``k_max`` edges keeps its ``k_max`` lowest; ``deg`` counts
    the kept edges, as the gather sums them. Assumes non-negative weights.
    """
    vals, idx = torch.sort(adj, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :topo.k_max], idx[:, :topo.k_max]
    return dataclasses.replace(
        topo, neighbor_idx=idx.to(torch.int32).contiguous(),
        neighbor_mask=vals.to(torch.float32).contiguous(),
        deg=vals.sum(dim=1).to(torch.float32))


def shift_circulant(topo: Topology, offsets: Sequence[int]) -> Topology:
    """A circulant with generator ``offsets`` d ∈ [1, (n−1)//2], carried as
    the signed shifts (d..., n − d...) in the reference's order. The bound
    keeps +d and −d distinct, so the degree 2K + 1 does not change under
    rotation. Host ints: a rotation costs the device nothing."""
    offs = [int(d) for d in offsets]
    return dataclasses.replace(topo, offsets=None,
                               shifts=tuple(offs + [topo.n - d for d in offs]))


# ---------------------------------------------------------------------------
# stacked topologies (the topology search's candidate axis)
# ---------------------------------------------------------------------------
#
# The reference vmaps its training scan over a stacked Topology. The port
# has no vmap that reaches through its kernels: the search stacks a cohort
# to give every sparse candidate the cohort's shared K_max, then unstacks it
# and runs each candidate's kernels on its own contiguous payloads. A
# stacked Topology (leading S axis) is for ``unstack`` only; the other
# functions of this module take unstacked ones.

def widen_sparse(topo: Topology, k_max: int) -> Topology:
    """Re-pad a sparse topology to a larger ``k_max``: each new slot
    indexes its own row with weight 0, the payload convention, so the
    graph, ``deg`` and the Eq. 3 kernels' results are unchanged."""
    if topo.kind != "sparse":
        raise ValueError(f"widen_sparse needs a sparse topology, "
                         f"got {topo.kind!r}")
    pad = k_max - topo.k_max
    if pad < 0:
        raise ValueError(f"cannot narrow k_max {topo.k_max} -> {k_max}")
    if pad == 0:
        return topo
    dev = topo.device
    self_idx = torch.arange(topo.n, dtype=torch.int32,
                            device=dev)[:, None].expand(topo.n, pad)
    return dataclasses.replace(
        topo,
        neighbor_idx=torch.cat([topo.neighbor_idx, self_idx], dim=1),
        neighbor_mask=torch.cat(
            [topo.neighbor_mask,
             torch.zeros((topo.n, pad), dtype=torch.float32, device=dev)],
            dim=1))


def stack(topos: Sequence[Topology], k_max: Optional[int] = None
          ) -> Topology:
    """S same-kind, same-n topologies along a new leading axis.

    * dense:     ``adj (S, N, N)``;
    * sparse:    each candidate re-padded (``widen_sparse``) to the shared
                 ``K_max = max(k_max, per-candidate K)``, then
                 ``neighbor_idx/mask (S, N, K_max)``;
    * circulant: every member must carry the same static ``offsets``;
                 scheduled ones carry ``shifts`` of one length, kept as a
                 tuple of per-candidate tuples.

    ``deg`` stacks to ``(S, N)`` in every case. Raises ``ValueError`` on
    an empty sequence, mixed kinds or sizes, and circulants that differ
    where the reference's stack cannot batch them."""
    topos = list(topos)
    if not topos:
        raise ValueError("stack needs at least one topology")
    kind, n = topos[0].kind, topos[0].n
    for t in topos:
        if t.kind != kind or t.n != n:
            raise ValueError(
                f"cannot stack mixed topologies: ({t.kind}, n={t.n}) vs "
                f"({kind}, n={n})")
    deg = torch.stack([t.deg for t in topos])
    if kind == "dense":
        return Topology(kind=kind, n=n, deg=deg,
                        adj=torch.stack([t.adj for t in topos]))
    if kind == "sparse":
        shared_k = max([k_max or 1] + [t.k_max for t in topos])
        topos = [widen_sparse(t, shared_k) for t in topos]
        return Topology(
            kind=kind, n=n, deg=deg,
            neighbor_idx=torch.stack([t.neighbor_idx for t in topos]),
            neighbor_mask=torch.stack([t.neighbor_mask for t in topos]))
    scheduled = [t.shifts is not None for t in topos]
    if any(scheduled) and not all(scheduled):
        raise ValueError("cannot stack static-offset and traced-shift "
                         "circulants together")
    if all(scheduled):
        lens = {len(t.shifts) for t in topos}
        if len(lens) > 1:
            raise ValueError(f"traced shift chains differ in length: "
                             f"{sorted(lens)}")
        return Topology(kind=kind, n=n, deg=deg,
                        shifts=tuple(t.shifts for t in topos))
    if len({t.offsets for t in topos}) > 1:
        raise ValueError(
            "static circulant offsets cannot vary across a stack; use "
            "traced shifts or the sparse representation for mixed-offset "
            "candidate pools")
    return Topology(kind=kind, n=n, deg=deg, offsets=topos[0].offsets)


def unstack(stacked: Topology) -> list:
    """Invert ``stack``: the per-candidate topologies, each payload a
    contiguous view of the stacked one (the kernels take contiguous
    operands)."""
    out = []
    for i in range(stacked.deg.shape[0]):
        kw = {name: getattr(stacked, name)[i]
              for name in ("deg", "adj", "neighbor_idx", "neighbor_mask",
                           "shifts")
              if getattr(stacked, name) is not None}
        out.append(dataclasses.replace(stacked, **kw))
    return out
