"""Sharded mega-fleets: the NetES agent axis over a process group
(DESIGN.md §13).

The port of ``repro.distributed.fleet_shard``. The reference runs one
``shard_map`` program over a device mesh; here each rank of a
``torch.distributed`` group (one process a rank, ``launch/mesh.py``) holds
its slab of ``n_loc = ⌈N/n_dev⌉`` agents, and cross-shard edges become
real collectives:

* **halo exchange** (sparse / static-circulant graphs): a host-side
  ``CommPlan`` groups every cross-shard edge by ring distance r; round r is
  ONE ``batch_isend_irecv`` in which each rank receives exactly the
  distinct boundary rows it needs from rank (s + r) mod n_dev (padded to
  the fleet-wide max ``H_r``). Neighbor lists are remapped into local+halo
  buffer coordinates with slot order preserved.
* **codec at the collective layer**: with a wire-quantizing channel the
  int8 codes and per-row scale are what the collectives move; the
  contraction reads the codes (``fused_neighbor_sum_rs``).
* **fully-connected** fleets never materialize an (N, N) adjacency: Eq. 3
  collapses to one rank-1 term from the all-gathered payload.
* **replicated fallback** (schedules, stateful channels): payloads are
  all-gathered and every rank runs the channel on all of them, then mixes
  its own rows of the live topology against all N senders.

The per-shard contraction is Eq. 3 with R = n_loc receivers (their own
unperturbed θ_j in the correction) against S sender rows of the payload
θ + σε: the receiver ≠ sender instances of the three Eq. 3 kernels
(``netes_sparse_mixing_rs``, ``fused_neighbor_sum_rs``,
``netes_mixing_rs``), whose plain versions are ``_slot_contract`` and
``_dense_contract`` (``kernels/ref.py``).

Shard-invariance contract: for a fixed seed the trajectory (θ, best θ and
reward, the generator), every metric, the channel counters and the probe
ring are IDENTICAL for any number of ranks, including 1, and identical to
the solo (``mesh=None``) engine. What makes it hold bitwise:

* the draws: every rank draws the step's whole ``core.netes.Draws`` from
  its copy of the same generator (so the solo engine sees exactly
  ``netes_step``'s draws) and keeps its rows;
* the contraction: each row is summed in slot (or source) order, each
  product rounded before its add, so a row's bits depend on its own slots
  alone — not on R, S, the buffer layout or the rank that holds it;
* the reductions: the reward gathers, fitness shaping and the broadcast
  row are taken on the gathered (N,) arrays; the spread metrics sum their
  moments in int64 fixed point (``_exact_moments``), which is exact in any
  order.

Row padding to ``n_pad = n_dev·n_loc`` adds phantom rows (θ 0, ε 0), which
are evaluated and dropped by the ``[:n]`` slices. ``reward_fn`` must be
row-decomposable (each row's return independent of the batch).

Unlike the reference (fold-in ε per agent), the noise is
``core.netes.draw``'s: a sharded run from a seed follows ``netes_step``'s
draws, and differs from it only in the contraction's rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import es_utils, netes, topology_repr, wire_format
from ..core.netes import Draws, NetESConfig, NetESState
from ..core.topology_repr import Topology
from ..kernels import ref
from ..kernels.netes_fused_mixing import (fused_broadcast_select,
                                          fused_neighbor_sum_rs)
from ..kernels.netes_mixing import netes_mixing_rs
from ..kernels.netes_sparse_mixing import netes_sparse_mixing_rs
from ..launch.mesh import Mesh, make_host_mesh

AXIS = "agents"


def build_mesh(num_shards: Optional[int] = None,
               device="cuda") -> Mesh:
    """The mesh of ``num_shards`` ranks (``launch.mesh.make_host_mesh``):
    the process group, this rank, the world size and the rank's device."""
    return make_host_mesh(num_shards, device=device)


@dataclasses.dataclass(frozen=True)
class FullyConnected:
    """Marker topology for an all-ones (self-loop included) graph whose
    (N, N) adjacency must never materialize: the engine's ``full`` mode
    contracts Eq. 3 as one rank-1 term from the gathered payload."""

    n: int


# ---------------------------------------------------------------------------
# host-side communication plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommPlan:
    """Everything a rank's step needs, precomputed in numpy.

    ``mode`` ∈ {halo, dense, full, replicated}; ``rounds`` is the static
    halo schedule, one ``(ring_distance, H_r)`` per NON-EMPTY round.
    ``operands`` hold the per-shard plan arrays laid out along axis 0:

    * ``send{r}``      (n_dev, H_r) int32 — local row each shard sends
    * ``gid_buf``      (n_dev, B)   int32 — global id per buffer slot
    * ``remap_idx``    (n_pad, K)   int32 — neighbor slots in buffer coords
    * ``remap_mask``   (n_pad, K)   f32   — edge weights (0 on padding)
    * ``adj_block``    (n_pad, n)   f32   — dense mode row block
    * ``deg``          (n_pad,)     f32   — row degrees (1 on phantoms)

    ``payload_rows`` is the per-shard, per-step count of payload rows
    RECEIVED over collectives — the realized-wire-bytes base.
    """

    mode: str
    n: int
    n_dev: int
    n_loc: int
    n_pad: int
    rounds: Tuple[Tuple[int, int], ...]
    operands: Dict[str, np.ndarray]
    payload_rows: int


def _neighbor_lists(topo: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """(idx, mask) global neighbor lists for the halo plan. Sparse
    topologies already carry them; a static circulant densifies its
    signed offsets into a (N, 1+|±Δ|) list — self first, then the sorted
    signed shifts."""
    if topo.kind == "sparse":
        return (topo.neighbor_idx.cpu().numpy().astype(np.int32),
                topo.neighbor_mask.cpu().numpy().astype(np.float32))
    if topo.kind == "circulant" and topo.shifts is None:
        n = topo.n
        shifts = topology_repr.signed_offsets(topo.offsets, n)
        j = np.arange(n, dtype=np.int32)[:, None]
        cols = [j] + [((j + d) % n).astype(np.int32) for d in shifts]
        idx = np.concatenate(cols, axis=1)
        mask = np.ones_like(idx, np.float32)
        return idx, mask
    raise ValueError(f"no neighbor-list form for kind={topo.kind!r}")


def make_comm_plan(topo, n_dev: int, channel=None,
                   schedule=None) -> CommPlan:
    """The static communication plan for ``topo`` over ``n_dev`` shards.
    Schedules and stateful channels (event / dropout stages need
    globally-consistent state) force ``replicated``; ``FullyConnected``
    gets the rank-1 ``full`` mode; sparse/static-circulant graphs get
    ``halo``; dense graphs get the row-block all-gather ``dense`` mode.
    Under a schedule ``topo`` may be None (N is the schedule's)."""
    stateful = channel is not None and not channel.collective_eligible
    if schedule is not None or stateful:
        if isinstance(topo, FullyConnected):
            raise ValueError(
                "FullyConnected has no Topology for the replicated "
                "fallback; use a dense TopologySpec for stateful "
                "channels / schedules at FC density")
        n = topo.n if topo is not None else getattr(schedule, "n", None)
        if n is None:
            raise ValueError("replicated mode needs a template topology")
        n_loc = -(-n // n_dev)
        n_pad = n_loc * n_dev
        return CommPlan(mode="replicated", n=n, n_dev=n_dev, n_loc=n_loc,
                        n_pad=n_pad, rounds=(), operands={},
                        payload_rows=n_pad - n_loc)

    if isinstance(topo, FullyConnected):
        n = topo.n
        n_loc = -(-n // n_dev)
        n_pad = n_loc * n_dev
        return CommPlan(mode="full", n=n, n_dev=n_dev, n_loc=n_loc,
                        n_pad=n_pad, rounds=(), operands={},
                        payload_rows=n_pad - n_loc)

    n = topo.n
    n_loc = -(-n // n_dev)
    n_pad = n_loc * n_dev

    if topo.kind == "dense":
        adj_block = np.zeros((n_pad, n), np.float32)
        adj_block[:n] = topo.adj.cpu().numpy()
        deg = np.ones((n_pad,), np.float32)
        deg[:n] = topo.deg.cpu().numpy()
        return CommPlan(mode="dense", n=n, n_dev=n_dev, n_loc=n_loc,
                        n_pad=n_pad, rounds=(),
                        operands={"adj_block": adj_block, "deg": deg},
                        payload_rows=n_pad - n_loc)

    idx, mask = _neighbor_lists(topo)
    k = idx.shape[1]
    # phantom rows: self-indexed, zero-weight — they contribute nothing
    # and receive nothing.
    idx_pad = np.concatenate(
        [idx, np.tile(np.arange(n, n_pad, dtype=np.int32)[:, None],
                      (1, k))], axis=0)
    mask_pad = np.concatenate([mask, np.zeros((n_pad - n, k), np.float32)],
                              axis=0)
    deg = np.ones((n_pad,), np.float32)
    deg[:n] = topo.deg.cpu().numpy()

    # needed[s][r]: sorted distinct global rows shard s must receive from
    # shard (s + r) % n_dev.
    needed = [[[] for _ in range(n_dev)] for _ in range(n_dev)]
    for s in range(n_dev):
        rows = slice(s * n_loc, (s + 1) * n_loc)
        gids = idx_pad[rows][mask_pad[rows] != 0]
        ext = np.unique(gids[gids // n_loc != s])
        for g in ext.tolist():
            r = (int(g) // n_loc - s) % n_dev
            needed[s][r].append(int(g))
    rounds = []
    for r in range(1, n_dev):
        h = max(len(needed[s][r]) for s in range(n_dev))
        if h:
            rounds.append((r, h))
    rounds = tuple(rounds)

    # buffer layout: [local slab | round 1 halo | round 2 | ...]
    b = n_loc + sum(h for _, h in rounds)
    gid_buf = np.zeros((n_dev, b), np.int32)
    pos_maps = []
    for s in range(n_dev):
        gid_buf[s, :n_loc] = np.arange(s * n_loc, (s + 1) * n_loc)
        pos = {int(g): i for i, g in enumerate(gid_buf[s, :n_loc])}
        off = n_loc
        for r, h in rounds:
            lst = needed[s][r]
            gid_buf[s, off:off + len(lst)] = lst
            gid_buf[s, off + len(lst):off + h] = s * n_loc  # inert pad
            for i, g in enumerate(lst):
                pos[g] = off + i
            off += h
        pos_maps.append(pos)

    operands: Dict[str, np.ndarray] = {"gid_buf": gid_buf, "deg": deg}
    # shard u's send list for round r serves requester (u - r) % n_dev.
    for r, h in rounds:
        send = np.zeros((n_dev, h), np.int32)
        for u in range(n_dev):
            lst = needed[(u - r) % n_dev][r]
            send[u, :len(lst)] = np.asarray(lst, np.int64) - u * n_loc
        operands[f"send{r}"] = send

    remap_idx = np.zeros((n_pad, k), np.int32)
    for j in range(n_pad):
        pm = pos_maps[j // n_loc]
        for c in range(k):
            if mask_pad[j, c] != 0:
                remap_idx[j, c] = pm[int(idx_pad[j, c])]
    operands["remap_idx"] = remap_idx
    operands["remap_mask"] = mask_pad

    return CommPlan(mode="halo", n=n, n_dev=n_dev, n_loc=n_loc,
                    n_pad=n_pad, rounds=rounds, operands=operands,
                    payload_rows=sum(h for _, h in rounds))


# ---------------------------------------------------------------------------
# collective layer: the same step code runs sharded and solo
# ---------------------------------------------------------------------------

class _ShardOps:
    """The collectives of one rank over ``mesh.group``. A failed
    collective raises; nothing carries on past it."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.n_dev = mesh, mesh.world_size
        self.group = mesh.group

    def axis_index(self) -> int:
        return self.mesh.rank

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` (m, ...) stacked along axis 0: (n_dev·m, ...)."""
        x = x.contiguous()
        out = torch.empty((self.n_dev * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.chunk(self.n_dev)), x, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def ppermute_recv(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """Round r of the halo: this rank s receives rank (s + r)'s ``x``
        and sends its own to rank (s − r), one batched exchange."""
        s, n = self.mesh.rank, self.n_dev
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (s - r) % n, group=self.group),
               dist.P2POp(dist.irecv, buf, (s + r) % n, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf


class _SoloOps:
    """The unsharded oracle: one shard, every collective is the identity.
    Shares all of the step code with ``_ShardOps`` runs."""

    n_dev = 1

    def axis_index(self) -> int:
        return 0

    def all_gather(self, x):
        return x

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def ppermute_recv(self, x, r):  # pragma: no cover - no rounds solo
        raise AssertionError("solo engine has no halo rounds")


# The plain versions of the per-shard contraction (``kernels/ref.py``):
# slot by slot and source by source, each product rounded before its add.
_slot_contract = ref.slot_contract
_dense_contract = ref.dense_contract


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float64, exactly, from the exponent bits (e an int tensor
    within float64's normal range)."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _exact_moments(ops, x: torch.Tensor, valid: torch.Tensor):
    """(Σ_rows x, Σ_rows x²) per column of the valid rows of every rank, as
    float64 (D,), the same bits for any split of the rows: each value is
    rounded once onto a grid of 2^-FRAC of the fleet-wide maximum (FRAC =
    62 − ⌈log2 rows⌉, so the int64 sums cannot overflow) and summed in
    int64, which is exact in any order."""
    rows = x.shape[0] * ops.n_dev
    frac = 62 - max(1, int(rows - 1).bit_length())
    xv = x.double() * valid[:, None]
    out = []
    for v in (xv, xv * xv):       # x² of a float32 is exact in float64
        top = ops.pmax(v.abs().amax().reshape(1))
        _, e = torch.frexp(top)          # top < 2**e
        q = torch.round(v * _pow2(frac - e)).to(torch.int64)
        total = ops.psum(q.sum(dim=0))
        out.append(total.double() * _pow2(e - frac))
    return out


def _rows(x: Optional[torch.Tensor], lo: int, n_loc: int, n: int,
          fill: str) -> Optional[torch.Tensor]:
    """Rows [lo, lo + n_loc) of the (N, ...) array ``x``; past N the
    phantom rows are zeros (``fill="zero"``) or repeat row N − 1
    (``fill="edge"``: valid inputs whose outputs are dropped)."""
    if x is None:
        return None
    hi = min(lo + n_loc, n)
    take = x[lo:hi] if hi > lo else x[:0]
    if hi - lo == n_loc:
        return take
    pad_rows = n_loc - max(hi - lo, 0)
    if fill == "zero":
        pad = x.new_zeros((pad_rows,) + tuple(x.shape[1:]))
    else:
        pad = x[n - 1:n].expand((pad_rows,) + tuple(x.shape[1:]))
    return torch.cat([take, pad])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ShardedNetES:
    """A NetES fleet over a process group (or solo, ``mesh=None``).

    Build once per (topology × config × mesh × channel/schedule) and call
    :meth:`run`. ``topo`` may be a ``Topology``, a ``FullyConnected``
    marker, or None with a ``schedule``. Every rank passes the same whole
    state; each steps its own rows and the result is gathered back.
    """

    def __init__(self, topo, reward_fn: Callable, cfg: NetESConfig,
                 mesh: Optional[Mesh] = None, channel=None, schedule=None,
                 probes=None):
        if topo is None and schedule is None:
            raise ValueError("need a topology or a schedule")
        self.mesh = mesh
        self.cfg = cfg
        self.reward_fn = reward_fn
        self.channel = channel
        self.schedule = schedule
        # DESIGN.md §15: probe samples read the reduced metrics, so every
        # rank records identical values into its ring.
        self.probes = probes
        n_dev = mesh.world_size if mesh is not None else 1
        self.topo = topo
        self.plan = make_comm_plan(topo, n_dev, channel=channel,
                                   schedule=schedule)
        self._static_msgs = None
        if channel is not None and self.plan.mode != "replicated":
            if self.plan.mode == "full":
                self._static_msgs = float(self.plan.n * (self.plan.n - 1))
            else:
                from ..comm.channel import realized_messages
                self._static_msgs = float(
                    realized_messages(topo, None, None).item())
        self._ops = _ShardOps(mesh) if mesh is not None else _SoloOps()
        self._placed: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    # -- operand placement -------------------------------------------------
    def _operands(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """This rank's rows of the plan operands, on ``device``."""
        if device not in self._placed:
            plan, s = self.plan, self._ops.axis_index()
            rows = slice(s * plan.n_loc, (s + 1) * plan.n_loc)
            ops = {}
            for k, v in plan.operands.items():
                v = v[s] if (k == "gid_buf" or k.startswith("send")) \
                    else v[rows]
                t = torch.as_tensor(np.ascontiguousarray(v), device=device)
                if k == "gid_buf" or k.startswith("send"):
                    t = t.long()
                ops[k] = t
            self._placed[device] = ops
        return self._placed[device]

    # -- step body (shared by sharded and solo) ---------------------------
    def _encode_payload(self, payload):
        """The channel's codec where the bytes move: wire-quantizing
        channels keep int8 codes + scale as the collective operands;
        other stateless codecs (topk) transform the float32 payload.
        Returns the parts tuple to move."""
        chan = self.channel
        if chan is None:
            return (payload,)
        if chan.wire_quantized:
            wp = chan.encode_wire(payload, batched=True)
            return (wp.codes, wp.scale)
        return (chan.codec(payload, batched=True),)

    def _contract(self, idx, mask, coeff, parts, th):
        """The sparse R × S instance on a payload in parts: the fused one
        on wire codes, the float32 one otherwise."""
        if len(parts) == 2:
            codes, scale = parts
            if self.channel.fused:
                return fused_neighbor_sum_rs(
                    idx, mask, coeff, codes, scale.reshape(-1, 1), th)
            parts = (wire_format.decode(codes, scale),)
        return netes_sparse_mixing_rs(idx, mask, coeff, parts[0], th)

    def _replicated_rows(self, topo: Topology, lo: int, hi: int, shaped,
                         wire, edge_mask, th):
        """Rows [lo, hi) of Eq. 3 on the live topology against all N
        senders (``wire``: a payload tensor or a ``WirePayload``)."""
        if topo.kind == "circulant":
            full = (wire_format.decode_payload(wire)
                    if isinstance(wire, wire_format.WirePayload) else wire)
            wnb = topology_repr.weighted_neighbor_sum(topo, shaped, full,
                                                      edge_mask)[lo:hi]
            wrs = topology_repr.weighted_row_sum(topo, shaped,
                                                 edge_mask)[lo:hi]
            return wnb - wrs[:, None] * th
        if topo.kind == "dense":
            adj = topo.adj[lo:hi]
            if edge_mask is not None:
                adj = adj * edge_mask[lo:hi]
            x = (wire_format.decode_payload(wire)
                 if isinstance(wire, wire_format.WirePayload) else wire)
            return netes_mixing_rs(adj, shaped, x, th)
        idx = topo.neighbor_idx[lo:hi]
        mask = topo.neighbor_mask[lo:hi]
        if edge_mask is not None:
            mask = mask * edge_mask[lo:hi]
        if isinstance(wire, wire_format.WirePayload):
            n = wire.codes.shape[0]
            return fused_neighbor_sum_rs(idx, mask, shaped,
                                         wire.codes.reshape(n, -1),
                                         wire.scale.reshape(n, 1), th)
        return netes_sparse_mixing_rs(idx, mask, shaped, wire, th)

    def _mix(self, ops, operands, th, pert_pos, shaped, shaped_pad,
             cs, ss, draws):
        """Per-mode Eq. 3 contraction of this rank's rows. Returns (out,
        deg, cs, chan_info): out = Σ a·R̃·x − (Σ a·R̃)·θ_j, before the
        scale."""
        plan, chan = self.plan, self.channel
        n, n_loc = plan.n, plan.n_loc

        if plan.mode == "replicated":
            topo = ss.topo if self.schedule is not None else self.topo
            pert_full = ops.all_gather(pert_pos)[:n]
            edge_mask = info = None
            wire = pert_full
            if chan is not None:
                chan_apply = (chan.apply_wire if chan.wire_fused(topo)
                              else chan.apply)
                wire, edge_mask, cs, info = chan_apply(
                    cs, topo, pert_full, edge_mask=draws.edge_mask)
            lo = ops.axis_index() * n_loc
            hi = min(lo + n_loc, n)
            live = max(hi - lo, 0)
            out = th.new_zeros(th.shape)
            deg = th.new_ones((n_loc,))
            if live:
                out[:live] = self._replicated_rows(
                    topo, lo, hi, shaped, wire, edge_mask, th[:live])
                deg[:live] = topo.deg[lo:hi]
            return out, deg, cs, info

        parts = self._encode_payload(pert_pos)

        if plan.mode == "halo":
            bufs = [parts]
            for r, _ in plan.rounds:
                sidx = operands[f"send{r}"]
                bufs.append(tuple(ops.ppermute_recv(p.index_select(0, sidx),
                                                    r) for p in parts))
            joined = tuple(torch.cat([b[i] for b in bufs])
                           for i in range(len(parts)))
            coeff_buf = shaped_pad[operands["gid_buf"]]
            out = self._contract(operands["remap_idx"],
                                 operands["remap_mask"], coeff_buf, joined,
                                 th)
            return out, operands["deg"], cs, None

        # dense / full: all-gather the encoded payload, decode, contract
        # over EXACTLY n sources.
        joined = tuple(ops.all_gather(p)[:n] for p in parts)
        buf = (wire_format.decode(*joined) if len(joined) == 2
               else joined[0])
        if plan.mode == "dense":
            out = netes_mixing_rs(operands["adj_block"], shaped, buf, th)
            return out, operands["deg"], cs, None
        # full: rank-1 — Σ_i R̃_i·x_i is one replicated (D,) vector.
        svec = shaped @ buf
        out = svec[None, :] - shaped.sum() * th
        deg = th.new_full((n_loc,), float(n))
        return out, deg, cs, None

    def _step(self, ops, operands, st: NetESState, cs, ss, ms,
              draws: Optional[Draws]):
        plan, cfg, chan = self.plan, self.cfg, self.channel
        n, n_loc = plan.n, plan.n_loc
        th = st.thetas
        dim = th.shape[1]
        lo = ops.axis_index() * n_loc
        if draws is None:
            draws = netes.draw(st, self.reward_fn, n, dim)
        eps = _rows(draws.eps, lo, n_loc, n, "zero")
        evals = _rows(draws.evals, lo, n_loc, n, "edge")
        valid = (torch.arange(lo, lo + n_loc, device=th.device)
                 < n).to(th.dtype)

        pert_pos = th + cfg.sigma * eps
        if cfg.antithetic:
            pert_neg = th - cfg.sigma * eps
            r = self.reward_fn(torch.cat([pert_pos, pert_neg]),
                               None if evals is None
                               else torch.cat([evals, evals]))
            both = ops.all_gather(r.reshape(2, n_loc).t())[:n]
            raw = torch.cat([both[:, 0], both[:, 1]])
            shaped_all = netes.shape_fitness(raw, cfg.fitness_shaping)
            shaped = shaped_all[:n] - shaped_all[n:]
        else:
            raw = ops.all_gather(self.reward_fn(pert_pos, evals))[:n]
            shaped = netes.shape_fitness(raw, cfg.fitness_shaping)
        shaped_pad = torch.cat([shaped, shaped.new_zeros(plan.n_pad - n)])

        out, deg, cs, info = self._mix(ops, operands, th, pert_pos, shaped,
                                       shaped_pad, cs, ss, draws)
        if cfg.normalization == "degree":
            scale = cfg.alpha / (deg[:, None] * cfg.sigma ** 2)
        else:
            scale = cfg.alpha / (n * cfg.sigma ** 2)
        update = es_utils.apply_weight_decay(th, scale * out,
                                             cfg.weight_decay)
        new_th = th + update

        # broadcast event: every rank offers its candidate row for the
        # argmax; the owner's is taken by index (exact, on the device).
        best_idx = torch.argmax(raw)
        best = best_idx.reshape(1)
        iter_best_reward = raw.index_select(0, best)[0]
        b0 = best_idx % n if cfg.antithetic else best_idx
        local = torch.clamp(b0 - lo, 0, n_loc - 1).reshape(1)
        row = pert_pos.index_select(0, local)
        if cfg.antithetic:
            row = torch.where(best_idx < n, row,
                              pert_neg.index_select(0, local))
        iter_best_theta = ops.all_gather(row).index_select(
            0, (b0 // n_loc).reshape(1))[0]
        do_b = draws.beta < cfg.p_broadcast
        if chan is not None and chan.fused and chan.wire_quantized:
            wp = chan.encode_wire(iter_best_theta, batched=False)
            new_th = fused_broadcast_select(wp.codes, wp.scale, do_b,
                                            new_th)
        else:
            bcast = (iter_best_theta if chan is None
                     else chan.codec(iter_best_theta, batched=False))
            new_th = torch.where(do_b, bcast[None, :], new_th)

        better = iter_best_reward > st.best_reward
        new_st = NetESState(
            thetas=new_th, generator=st.generator, step=st.step + 1,
            best_reward=torch.where(better, iter_best_reward,
                                    st.best_reward),
            best_theta=torch.where(better, iter_best_theta, st.best_theta))

        def spread(x):
            s1, s2 = _exact_moments(ops, x, valid)
            return ((s2 / n) - (s1 / n) ** 2).sum().to(torch.float32)

        metrics = {
            "reward_mean": raw.mean(),
            "reward_max": raw.max(),
            "reward_min": raw.min(),
            "reward_std": raw.std(correction=0),
            "update_var": spread(update),
            "broadcast": do_b.to(torch.float32),
            "theta_spread": spread(new_th),
            "best_idx": best_idx,
        }
        if chan is not None:
            bcast_msgs = do_b.to(torch.float32) * n
            if info is None:    # stateless codec modes: every live edge
                mix_msgs = torch.full((), self._static_msgs,
                                      dtype=torch.float32, device=th.device)
                cs = dataclasses.replace(cs, msgs=cs.msgs + mix_msgs)
                metrics["trigger_frac"] = torch.ones(
                    (), dtype=torch.float32, device=th.device)
                metrics["drop_frac"] = torch.zeros(
                    (), dtype=torch.float32, device=th.device)
            else:               # the channel's apply counted its messages
                mix_msgs = info["msgs"]
                metrics["trigger_frac"] = info["trigger_frac"]
                metrics["drop_frac"] = info["drop_frac"]
            metrics["msgs"] = mix_msgs + bcast_msgs
            cs = dataclasses.replace(cs, msgs=cs.msgs + bcast_msgs)
        if self.probes is not None:
            # graph probes read the LIVE topology (before the advance, as
            # core.netes.scheduled_step); FullyConnected has none
            live = ss.topo if self.schedule is not None else (
                self.topo if isinstance(self.topo, Topology) else None)
            self.probes.record(ms, metrics, live)
        if self.schedule is not None:
            ss = self.schedule.advance(ss, draws.schedule_u)
        return new_st, cs, ss, metrics

    # -- run ---------------------------------------------------------------
    def run(self, state: NetESState, num_iters: int, chan_state=None,
            sched_state=None, metrics_state=None,
            draws: Optional[Sequence[Draws]] = None):
        """``num_iters`` steps from the whole-population ``state`` (the
        same on every rank). Returns ``(state, metrics)`` with the
        gathered state and the metrics stacked per iteration; with a
        schedule its state slots in before the metrics, then a channel's;
        with probes the ring (updated in place) right before the metrics.
        ``draws``, if given, holds each iteration's ``Draws``."""
        plan, ops = self.plan, self._ops
        n, _ = state.thetas.shape
        if n != plan.n:
            raise ValueError(f"state has {n} agents, plan expects {plan.n}")
        if self.probes is not None and metrics_state is None:
            raise ValueError("probes need their ring: pass metrics_state")
        dev = state.thetas.device
        if self.mesh is not None and dev != self.mesh.device:
            raise ValueError(f"state on {dev}, this rank's device is "
                             f"{self.mesh.device}")
        operands = self._operands(dev)
        lo = ops.axis_index() * plan.n_loc
        st = dataclasses.replace(
            state, thetas=_rows(state.thetas, lo, plan.n_loc, n, "zero"))
        cs, ss = chan_state, sched_state
        history = []
        for it in range(num_iters):
            st, cs, ss, m = self._step(ops, operands, st, cs, ss,
                                       metrics_state,
                                       None if draws is None else draws[it])
            history.append(m)
        thetas = ops.all_gather(st.thetas)[:n]
        out = (dataclasses.replace(st, thetas=thetas),)
        if self.schedule is not None:
            out = out + (ss,)
        if self.channel is not None:
            out = out + (cs,)
        if self.probes is not None:
            out = out + (metrics_state,)
        return out + (netes._stack(history),)

    # -- realized traffic, from the collective buffers' shapes ------------
    def collective_bytes(self, dim: int) -> Dict[str, int]:
        """Per-shard, per-step bytes moved by this engine's collectives,
        from the static buffer shapes the step exchanges. Wire-quantized
        channels move int8 codes + one f32 scale per row; everything else
        moves f32 rows. ``reward_bytes`` covers the (±ε) reward gathers;
        ``broadcast_bytes`` the best row."""
        plan, chan = self.plan, self.channel
        wired = (chan is not None and chan.wire_quantized
                 and plan.mode != "replicated")
        row = dim * 1 + 4 if wired else dim * 4
        payload = plan.payload_rows * row
        rewards = (plan.n_pad - plan.n_loc) * 4 * \
            (2 if self.cfg.antithetic else 1)
        broadcast = dim * 4
        return {
            "payload_rows": plan.payload_rows,
            "payload_bytes": payload,
            "reward_bytes": rewards,
            "broadcast_bytes": broadcast,
            "total_bytes": payload + rewards + broadcast,
        }


# ---------------------------------------------------------------------------
# engine cache + the core/netes mesh= entry points
# ---------------------------------------------------------------------------

# Keyed by object identity; the engine holds strong references, so the ids
# stay valid. Pass a STABLE Topology object across calls (as the train loop
# does): a fresh Topology per call builds a new plan.
_ENGINE_CACHE: Dict[Any, ShardedNetES] = {}


def clear_engine_cache():
    _ENGINE_CACHE.clear()


def _get_engine(topo, reward_fn, cfg, mesh, channel, schedule,
                probes=None) -> ShardedNetES:
    key = (id(topo), id(schedule), id(reward_fn), cfg, id(channel),
           id(mesh), id(probes))
    eng = _ENGINE_CACHE.get(key)
    if eng is None or not all(
            a is b for a, b in ((eng.topo, topo), (eng.schedule, schedule),
                                (eng.reward_fn, reward_fn),
                                (eng.channel, channel), (eng.mesh, mesh),
                                (eng.probes, probes))):
        eng = ShardedNetES(topo, reward_fn, cfg, mesh=mesh,
                           channel=channel, schedule=schedule,
                           probes=probes)
        _ENGINE_CACHE[key] = eng
    return eng


def _as_core_return(out, channel, probes, scheduled: bool):
    """An engine return as ``core.netes.run`` (``run_scheduled``) returns
    it: ``(state, [sched_state,] chan_state, [metrics_state,] metrics)``,
    chan_state None without a channel."""
    out = list(out)
    metrics = out.pop()
    ms = out.pop() if probes is not None else None
    cs = out.pop() if channel is not None else None
    ss = out.pop() if scheduled else None
    (state,) = out
    head = (state, ss, cs) if scheduled else (state, cs)
    return head + ((ms,) if probes is not None else ()) + (metrics,)


def run_sharded(state: NetESState, adj, reward_fn: Callable,
                cfg: NetESConfig, num_iters: int, mesh: Optional[Mesh],
                channel=None, chan_state=None, probes=None,
                metrics_state=None):
    """``core.netes.run``'s ``mesh=`` backend (mesh=None runs the solo
    engine), with ``core.netes.run``'s return. ``adj`` should be a stable
    ``Topology`` or ``FullyConnected`` instance."""
    topo = adj if isinstance(adj, (Topology, FullyConnected)) \
        else topology_repr.as_topology(adj, device=state.thetas.device)
    eng = _get_engine(topo, reward_fn, cfg, mesh, channel, None,
                      probes=probes)
    out = eng.run(state, num_iters, chan_state=chan_state,
                  metrics_state=metrics_state)
    return _as_core_return(out, channel, probes, scheduled=False)


def run_sharded_scheduled(state: NetESState, sched_state,
                          reward_fn: Callable, cfg: NetESConfig, schedule,
                          num_iters: int, mesh: Optional[Mesh],
                          channel=None, chan_state=None, probes=None,
                          metrics_state=None):
    """``core.netes.run_scheduled``'s ``mesh=`` backend (replicated mixing:
    every rank keeps the whole topology state), with its return."""
    eng = _get_engine(None, reward_fn, cfg, mesh, channel, schedule,
                      probes=probes)
    out = eng.run(state, num_iters, chan_state=chan_state,
                  sched_state=sched_state, metrics_state=metrics_state)
    return _as_core_return(out, channel, probes, scheduled=True)


# ---------------------------------------------------------------------------
# contract-linter registry hook (repro_torch.analysis)
# ---------------------------------------------------------------------------

# Product ratchets, counted on the toy shapes below (a seam's products are
# each rounded before their add, the shard-invariance contract above;
# raising a count is always fine, dropping below it means a product was
# fused or dropped). The reference counts optimization barriers (10 on a
# step, 6 on the slot loop, 4 on the dense loop's 4-unrolled body); the
# port counts the rank ≥ 2 products themselves:
#   * slot_contract at (R, K) = (4, 6): one (R, D) product a slot, 6;
#   * dense_contract at (R, S) = (4, 8): one (R, D) product a source, 8;
#   * the engine's run (2 iterations at N = 8, D = 16): its contraction
#     runs in the R × S kernel (shape-only on fake tensors), so the count
#     is the step's own rank ≥ 2 products (σ·ε, the update, the broadcast
#     select, the spread metrics), 13 an iteration.
STEP_MIN_PRODUCTS = 26


def analysis_entry_points():
    """Contract-linter entry points: the sharded engine's run (solo, and
    over a process group of two ranks, product-ratcheted) and the two
    seam leaf contractions under the fused-seam contract: every product
    in them must round before its add."""
    from ..analysis.registry import EntryPoint, SphereReward, toy_state

    def _engine_run(mesh, device, n=8):
        # the engine's comm plan is made on the host, from a real graph
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        from ..core import topology
        with unset_fake_temporarily():
            topo = topology_repr.as_topology(
                topology.erdos_renyi(n, p=0.5, seed=0), device="cpu")
            eng = ShardedNetES(topo, SphereReward(), NetESConfig(),
                               mesh=mesh)
        return (lambda st: eng.run(st, 2), (toy_state(device, n),), {})

    def build_solo_step(device):
        return _engine_run(None, device)

    def build_sharded_step(device):
        mesh = Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    world_size=dist.get_world_size(),
                    device=torch.device(device))
        return _engine_run(mesh, device)

    def build_slot_contract(device):
        return (_slot_contract,
                (torch.zeros((4, 6), dtype=torch.int32, device=device),
                 torch.ones((4, 6), dtype=torch.float32, device=device),
                 torch.ones((8, 16), dtype=torch.float32, device=device)),
                {})

    def build_dense_contract(device):
        return (_dense_contract,
                (torch.ones((4, 8), dtype=torch.float32, device=device),
                 torch.ones((8,), dtype=torch.float32, device=device),
                 torch.ones((8, 16), dtype=torch.float32, device=device)),
                {})

    seam = ("no-host-sync", "fused-seam-product")
    return (
        EntryPoint(name="fleet_shard.solo_step", build=build_solo_step,
                   carry=(("state", 0, 0),),
                   min_products=STEP_MIN_PRODUCTS),
        EntryPoint(name="fleet_shard.sharded_step",
                   build=build_sharded_step, min_devices=2,
                   carry=(("state", 0, 0),),
                   min_products=STEP_MIN_PRODUCTS),
        EntryPoint(name="fleet_shard.slot_contract",
                   build=build_slot_contract, contracts=seam,
                   min_products=6),
        EntryPoint(name="fleet_shard.dense_contract",
                   build=build_dense_contract, contracts=seam,
                   min_products=8),
    )
