"""Lossy communication channels between learning agents (DESIGN.md §11).

The port of ``repro.comm.channel``. A channel is a pipeline of stages
applied in order to every per-agent payload of a NetES step (and to the
broadcast of the best agent):

* ``lossless`` — the identity;
* ``quantize(bits∈{8,4,1})`` — per-message symmetric uniform quantization
  with an absmax scale; ``bits=1`` is sign(x)·mean|x|;
* ``topk(frac)`` — keep the ceil(frac·m) largest-|x| entries of each
  message; among equal magnitudes the lower index wins, as in the
  reference's ``lax.top_k`` (a quantized payload has many such ties);
* ``event_triggered(threshold)`` — a source re-sends only when the RMS
  change of its message against its last transmitted one exceeds
  ``threshold``; receivers otherwise reuse the stale message
  (``ChannelState.last_sent``);
* ``dropout(p, seed)`` — each undirected link fails with probability p
  per step, both directions at once.

**Dropout draws.** The reference draws each link's fate from threefry
(``fold_in`` of the canonical edge id min·n + max under a key split once per
step). The port does not reproduce threefry. It draws from a stateless
integer hash of (stage seed, draw counter, edge id), computed with int64
tensor ops on the device (``step_key``, ``dropout_mask``): the same link
fails in every representation and in both directions, self-loops never
fail, each link survives with probability 1 − p (p rounded up to a
multiple of 2⁻²⁴), and the bits are the same on the CPU and on the GPU.
``ChannelState`` carries the seed and the counter in place of the key.
A caller that needs the reference's own masks passes them in
(``Channel.apply(..., edge_mask=...)``, ``core.netes.Draws.edge_mask``).

A payload is an (N, ...) tensor, or a tree (nested dicts, lists and
tuples) of (N, ...) leaves, as the distributed replica step sends its
parameters. In a tree, one message is one agent's whole tree: the
quantize and top-k stages work per leaf and agent, the event trigger fires
per agent across all leaves, and one drop mask a step serves every leaf.
The quantize stage encodes a leaf ``WIRE_COLUMNS`` columns at a time
(``wire_format.encode_columns``), so that a leaf of billions of elements
needs no float temporary of its size.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Optional, Tuple, Union

import torch

from ..core import topology_repr, wire_format
from ..core.topology_repr import Topology
from ..core.tree import flatten, tree_map

# The codec's decode, uniform across q8/q4/q1 (``core.wire_format``).
decode_block = wire_format.decode

# Columns of a leaf's (N, P) view encoded at once.
WIRE_COLUMNS = 1 << 24

STAGE_KINDS = ("lossless", "quantize", "topk", "event_triggered",
               "dropout")
QUANTIZE_BITS = (8, 4, 1)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage (serializable, hashable)."""

    kind: str
    bits: int = 8             # quantize: 8 | 4 | 1 (sign)
    frac: float = 0.25        # topk: fraction of entries kept
    threshold: float = 0.0    # event_triggered: RMS re-send threshold
    p: float = 0.0            # dropout: per-link failure probability
    seed: int = 0             # dropout: PRF seed

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"unknown channel stage {self.kind!r}; "
                             f"available: {STAGE_KINDS}")
        if self.kind == "quantize" and self.bits not in QUANTIZE_BITS:
            raise ValueError(f"quantize needs bits in {QUANTIZE_BITS}, "
                             f"got {self.bits}")
        if self.kind == "topk" and not 0.0 < self.frac <= 1.0:
            raise ValueError(f"topk needs 0 < frac <= 1, got {self.frac}")
        if self.kind == "event_triggered" and self.threshold < 0:
            raise ValueError("event_triggered needs threshold >= 0")
        if self.kind == "dropout" and not 0.0 <= self.p < 1.0:
            raise ValueError(f"dropout needs 0 <= p < 1, got {self.p}")

    def label(self) -> str:
        return {
            "lossless": "id",
            "quantize": f"q{self.bits}",
            "topk": f"top{self.frac:g}",
            "event_triggered": f"evt{self.threshold:g}",
            "dropout": f"drop{self.p:g}",
        }[self.kind]


_FLOAT_KEYS = ("frac", "threshold", "p")
_STAGE_ARGS = ("bits", "frac", "threshold", "p", "seed")


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Serializable channel description (``TrainConfig.channel``).

    ``stages`` apply in order; an empty tuple is the lossless channel. At
    most one ``event_triggered`` and one ``dropout`` stage.
    """

    stages: Tuple[StageSpec, ...] = ()

    def __post_init__(self):
        stages = tuple(s for s in self.stages if s.kind != "lossless")
        object.__setattr__(self, "stages", stages)
        for kind in ("event_triggered", "dropout"):
            if sum(s.kind == kind for s in stages) > 1:
                raise ValueError(f"at most one {kind} stage per channel")

    @property
    def lossless(self) -> bool:
        return not self.stages

    @classmethod
    def parse(cls, text: str) -> "ChannelSpec":
        """``"lossless" | "quantize(bits=8)" |
        "event_triggered(threshold=0.01)|quantize(bits=4)|dropout(p=0.1,
        seed=3)"`` — stages separated by ``|``, applied left to right."""
        stages = []
        for part in text.split("|"):
            m = re.fullmatch(r"\s*(\w+)\s*(?:\(([^)]*)\))?\s*", part)
            if not m:
                raise ValueError(f"unparseable channel stage {part!r}")
            kind, argstr = m.group(1), m.group(2) or ""
            kw = {}
            for item in filter(None,
                               (p.strip() for p in argstr.split(","))):
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(
                        f"channel arg {item!r} is not key=value")
                k = k.strip()
                if k not in _STAGE_ARGS:
                    raise ValueError(f"unknown channel stage arg {k!r}; "
                                     f"available: {sorted(_STAGE_ARGS)}")
                kw[k] = float(v) if k in _FLOAT_KEYS else int(v)
            stages.append(StageSpec(kind=kind, **kw))
        return cls(stages=tuple(stages))

    def label(self) -> str:
        if self.lossless:
            return "lossless"
        return "|".join(s.label() for s in self.stages)


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """What a channel carries from one step to the next, on the device.

    ``seed`` and ``draws`` key the dropout PRF (they stand where the
    reference keeps its threefry key): the dropout stage's seed, and the
    number of masks drawn so far. ``last_sent`` is the per-agent last
    transmitted payload, a tensor or a tree as the payload is (event
    triggering; None without an event stage),
    and ``msgs`` the cumulative count of realized directed messages.
    """

    seed: torch.Tensor                 # () int64
    draws: torch.Tensor                # () int64
    last_sent: Optional[Any]           # payload-shaped, or None
    msgs: torch.Tensor                 # () float32


@dataclasses.dataclass(frozen=True)
class Channel:
    """A ``ChannelSpec`` compiled for ``n`` agents.

    ``fused`` (default True): when the pipeline is ``wire_quantized``, a
    step on a sparse graph hands the mixing the encoded ``WirePayload``
    (``apply_wire``) and the broadcast goes through
    ``kernels.netes_fused_mixing.fused_broadcast_select``. False keeps the
    decode-then-contract path. The channel's semantics are the same
    either way.
    """

    spec: ChannelSpec
    n: int
    fused: bool = True

    @property
    def lossless(self) -> bool:
        return self.spec.lossless

    def _stage(self, kind: str) -> Optional[StageSpec]:
        for s in self.spec.stages:
            if s.kind == kind:
                return s
        return None

    @property
    def event_stage(self) -> Optional[StageSpec]:
        return self._stage("event_triggered")

    @property
    def dropout_stage(self) -> Optional[StageSpec]:
        return self._stage("dropout")

    @property
    def quantize_stage(self) -> Optional[StageSpec]:
        return self._stage("quantize")

    @property
    def transforms_payload(self) -> bool:
        """True iff a stage changes the payload's values (quantize, topk,
        event_triggered); lossless and dropout-only channels pass the
        payload through unchanged."""
        return any(s.kind != "dropout" for s in self.spec.stages)

    @property
    def wire_quantized(self) -> bool:
        """True iff the pipeline admits the wire form: exactly one
        quantize stage, followed by nothing but dropout."""
        kinds = [s.kind for s in self.spec.stages]
        if kinds.count("quantize") != 1:
            return False
        after = kinds[kinds.index("quantize") + 1:]
        return all(k == "dropout" for k in after)

    @property
    def collective_eligible(self) -> bool:
        """True iff every stage is a stateless payload codec (quantize,
        topk): the subset a collective-layer wire encoder can apply
        (DESIGN.md §13). Event triggers and dropout carry state or need
        globally consistent draws, so a sharded engine falls back to
        replicated mixing for them (``distributed/fleet_shard``)."""
        return self.event_stage is None and self.dropout_stage is None

    def wire_fused(self, topo: Topology) -> bool:
        """Whether a step on ``topo`` mixes from the wire form: sparse
        graphs only, where the fused kernel replaces the (N, K, D) gather
        of decoded values; dense and circulant keep the fake-quant path."""
        return self.fused and self.wire_quantized and topo.kind == "sparse"

    @property
    def elem_bytes(self) -> float:
        """Wire bytes per float32 payload element under the encoding:
        quantization narrows each element, top-k sends ``frac`` of them
        (value + int32 index each)."""
        bits, frac, index_bits = 32, 1.0, 0
        for s in self.spec.stages:
            if s.kind == "quantize":
                bits = s.bits
            elif s.kind == "topk":
                frac = s.frac
                index_bits = 32
        return frac * (bits + index_bits) / 8.0

    def payload_bytes(self, d: int) -> float:
        """Wire bytes of one encoded d-element message."""
        return d * self.elem_bytes

    # -- state ------------------------------------------------------------
    def init(self, template: Any) -> ChannelState:
        """Step-0 state for payloads shaped like ``template`` (an (N, ...)
        tensor or a tree of them), on its device."""
        dev = flatten(template)[0].device
        seed = self.dropout_stage.seed if self.dropout_stage else 0
        return ChannelState(
            seed=torch.tensor(seed, dtype=torch.int64, device=dev),
            draws=torch.zeros((), dtype=torch.int64, device=dev),
            last_sent=(tree_map(torch.zeros_like, template)
                       if self.event_stage else None),
            msgs=torch.zeros((), dtype=torch.float32, device=dev))

    # -- per step ---------------------------------------------------------
    def apply(self, state: ChannelState, topo: Topology, payload: Any,
              edge_mask: Optional[torch.Tensor] = None):
        """One channel step over the per-source payloads, an ``(N, ...)``
        tensor or a tree of them (one message = one agent's whole tree).

        Returns ``(payload', edge_mask, state', info)``: the payload the
        receivers see (fake-quantized), a representation-matched live-link
        mask or None, the advanced state, and ``info`` with this step's
        ``msgs``, ``trigger_frac`` and ``drop_frac`` (0-d tensors).
        ``edge_mask``, if given, replaces the dropout stage's own draw (the
        draw counter still advances); it needs a dropout stage.
        """
        return self._run(state, topo, payload, False, edge_mask)

    def apply_wire(self, state: ChannelState, topo: Topology, payload: Any,
                   edge_mask: Optional[torch.Tensor] = None):
        """``apply`` with the quantize stage left in wire form: the same
        stage order, triggers, masks and counts, but the payload comes
        back as a ``WirePayload`` (a tree of them for a tree). Needs
        ``wire_quantized``."""
        if not self.wire_quantized:
            raise ValueError(
                f"channel {self.spec.label()!r} is not wire-encodable: "
                "apply_wire needs exactly one quantize stage with only "
                "dropout after it (see Channel.wire_quantized)")
        return self._run(state, topo, payload, True, edge_mask)

    def _run(self, state, topo, payload, wire, edge_mask):
        if edge_mask is not None and self.dropout_stage is None:
            raise ValueError("an injected edge_mask needs a dropout stage")
        x = payload
        last, draws = state.last_sent, state.draws
        triggered = mask = None
        for st in self.spec.stages:
            if st.kind == "quantize":
                x = tree_map(functools.partial(
                    _encode if wire else _quantize, bits=st.bits,
                    batched=True), x)
            elif st.kind == "topk":
                x = tree_map(functools.partial(_keep_topk, frac=st.frac,
                                               batched=True), x)
            elif st.kind == "event_triggered":
                x, last, triggered = _event_select(x, state.last_sent,
                                                   st.threshold)
            else:  # dropout
                mask = (dropout_mask(step_key(state.seed, draws), topo, st.p)
                        if edge_mask is None else edge_mask)
                draws = draws + 1
        msgs = realized_messages(topo, mask, triggered)
        info = self._info(topo, mask, triggered, msgs)
        new_state = ChannelState(seed=state.seed, draws=draws,
                                 last_sent=last, msgs=state.msgs + msgs)
        return x, mask, new_state, info

    def _info(self, topo, edge_mask, triggered, msgs) -> dict:
        """This step's ``msgs``, the event stage's ``trigger_frac`` (1
        without one) and the dropout stage's ``drop_frac``: dropped over
        would-have-moved messages, 0 without a dropout stage."""
        dev = msgs.device
        info = {"msgs": msgs,
                "trigger_frac": (torch.ones((), device=dev)
                                 if triggered is None
                                 else triggered.float().mean())}
        if self.dropout_stage is not None and edge_mask is not None:
            potential = realized_messages(topo, None, triggered)
            info["drop_frac"] = torch.where(
                potential > 0, 1.0 - msgs / potential.clamp_min(1.0),
                torch.zeros((), device=dev))
        else:
            info["drop_frac"] = torch.zeros((), device=dev)
        return info

    def codec(self, x: Any, batched: bool = False) -> Any:
        """The stateless payload compression alone (quantize, topk), for
        payloads outside the mixing links: the broadcast of the best
        agent. ``batched=False`` treats each leaf of ``x`` as one
        message."""
        for st in self.spec.stages:
            if st.kind == "quantize":
                x = tree_map(functools.partial(_quantize, bits=st.bits,
                                               batched=batched), x)
            elif st.kind == "topk":
                x = tree_map(functools.partial(_keep_topk, frac=st.frac,
                                               batched=batched), x)
        return x

    def encode_wire(self, x: Any, batched: bool = False):
        """``codec`` with the quantize stage left in wire form: a
        ``WirePayload`` (a tree of them for a tree) for
        ``fused_broadcast_select``. Needs ``wire_quantized``."""
        if not self.wire_quantized:
            raise ValueError(
                f"channel {self.spec.label()!r} is not wire-encodable "
                "(see Channel.wire_quantized)")
        for st in self.spec.stages:
            if st.kind == "quantize":
                x = tree_map(functools.partial(_encode, bits=st.bits,
                                               batched=batched), x)
            elif st.kind == "topk":
                x = tree_map(functools.partial(_keep_topk, frac=st.frac,
                                               batched=batched), x)
        return x


def compile_channel(spec: Optional[Union[ChannelSpec, str]], n: int,
                    fused: bool = True) -> Channel:
    """A ``ChannelSpec`` (or its string form; None is lossless) compiled
    for n agents. ``fused=False`` keeps the decode-then-contract path."""
    if spec is None:
        spec = ChannelSpec()
    elif isinstance(spec, str):
        spec = ChannelSpec.parse(spec)
    return Channel(spec=spec, n=n, fused=fused)


# ---------------------------------------------------------------------------
# payload codecs (rowwise when batched)
# ---------------------------------------------------------------------------

def _encode(x: torch.Tensor, bits: int,
            batched: bool) -> wire_format.WirePayload:
    """``wire_format.encode``, bit for bit, a column slab at a time."""
    if batched:
        return wire_format.encode_columns(x, bits, WIRE_COLUMNS)
    wp = wire_format.encode_columns(x[None], bits, WIRE_COLUMNS)
    return wire_format.WirePayload(codes=wp.codes[0], scale=wp.scale[0],
                                   dtype=wp.dtype)


def _quantize(x: torch.Tensor, bits: int, batched: bool) -> torch.Tensor:
    """Symmetric uniform quantization with a per-message absmax scale;
    ``bits=1`` is sign(x)·mean|x|. The fake-quant is the decode of the
    wire form, so both paths mix the same numbers."""
    return wire_format.decode_payload(wire_format.encode(x, bits, batched))


def _keep_topk(x: torch.Tensor, frac: float, batched: bool) -> torch.Tensor:
    """Keep the ceil(frac·m) largest-|x| entries per message, zero the
    rest. A stable descending sort picks them, so ties go to the lower
    index as in ``lax.top_k`` (``torch.topk`` makes no promise on ties)."""
    if frac >= 1.0:
        return x
    lead = x.shape[0] if batched else 1
    flat = x.reshape(lead, -1)
    m = flat.shape[1]
    k = max(1, int(math.ceil(frac * m)))
    if k >= m:
        return x
    idx = torch.sort(flat.abs(), dim=1, descending=True,
                     stable=True).indices[:, :k]
    keep = torch.zeros_like(flat).scatter_(1, idx, 1.0)
    return (flat * keep).reshape(x.shape)


def _event_select(x: Any, last: Any, threshold: float):
    """Source i re-sends iff the RMS change of its message (its rows of
    every leaf) against the last transmitted one exceeds ``threshold``
    (strictly). Returns (payload, new last-sent reference, triggered (N,)
    bool)."""
    pairs = list(zip(flatten(x), flatten(last), strict=True))
    lead = pairs[0][0]
    n = lead.shape[0]
    sq = sum(((a.float() - b.float()).reshape(n, -1) ** 2).sum(dim=1)
             for a, b in pairs)
    dims = torch.full((), float(max(sum(a[0].numel() for a, _ in pairs), 1)),
                      device=lead.device)
    triggered = torch.sqrt(sq / dims) > threshold

    def select(new, old):
        return torch.where(triggered.reshape((n,) + (1,) * (new.ndim - 1)),
                           new, old)

    wire = tree_map(select, x, last)
    return wire, wire, triggered


# ---------------------------------------------------------------------------
# fault injection: symmetric per-link dropout masks
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x · m) mod 2³² for int64 ``x`` in [0, 2³²): the product is split in
    16-bit halves of m so that no int64 intermediate overflows."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply, constants of Wellons'
    ``lowbias32``), a bijection of [0, 2³²) held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def step_key(seed: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """The PRF key of one dropout draw: a hash of (seed, draw counter),
    both taken mod 2³²."""
    k = _mix32((seed & _M32) ^ 0x9E3779B9)
    return _mix32(k ^ (draw & _M32) ^ 0x85EBCA6B)


def _edge_keep(key: torch.Tensor, ids: torch.Tensor, p: float) -> torch.Tensor:
    """float32 keep mask, 1 with probability 1 − p per edge id: the top 24
    bits of hash(key, id) against ceil(p·2²⁴)."""
    h = _mix32(key ^ (ids & _M32))
    h = _mix32(h ^ (ids >> 32) ^ 0xC2B2AE35)
    return ((h >> 8) >= math.ceil(p * (1 << 24))).to(torch.float32)


def _edge_ids(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical undirected edge id: min·n + max (symmetric in (a, b))."""
    return (torch.minimum(a, b).long() * n + torch.maximum(a, b).long())


def dropout_mask(key: torch.Tensor, topo: Topology, p: float) -> torch.Tensor:
    """Representation-matched live-link mask of one draw: dense (N, N),
    sparse (N, K_max) slot-aligned, circulant (|±Δ|, N) (one row per ring
    shift, indexed by receiver). Self-loops never drop."""
    n, dev = topo.n, topo.device
    j = torch.arange(n, device=dev)
    if topo.kind == "dense":
        keep = _edge_keep(key, _edge_ids(j[:, None], j[None, :], n), p)
        return torch.where(j[:, None] == j[None, :], 1.0, keep)
    if topo.kind == "sparse":
        idx = topo.neighbor_idx.long()
        keep = _edge_keep(key, _edge_ids(j[:, None], idx, n), p)
        return torch.where(idx == j[:, None], 1.0, keep)
    shifts = topology_repr.circulant_shifts(topo)
    if not shifts:
        return torch.zeros((0, n), dtype=torch.float32, device=dev)
    return torch.stack([_edge_keep(key, _edge_ids(j, (j + d) % n, n), p)
                        for d in shifts])


def realized_messages(topo: Topology, edge_mask: Optional[torch.Tensor],
                      triggered: Optional[torch.Tensor]) -> torch.Tensor:
    """Directed mixing messages that moved this step: live non-self edges
    whose source transmitted. A float32 0-d tensor (exact: per-step counts
    stay far below 2²⁴)."""
    n, dev = topo.n, topo.device
    trig = (torch.ones(n, device=dev) if triggered is None
            else triggered.float())
    if topo.kind == "dense":
        live = ((topo.adj != 0).float()
                * (1.0 - torch.eye(n, device=dev)))
        if edge_mask is not None:
            live = live * edge_mask
        return (live * trig[None, :]).sum()     # adj[j, i]: source i
    if topo.kind == "sparse":
        idx = topo.neighbor_idx.long()
        rows = torch.arange(n, device=dev)[:, None]
        live = ((topo.neighbor_mask != 0) & (idx != rows)).float()
        if edge_mask is not None:
            live = live * edge_mask
        return (live * trig[idx]).sum()
    total = torch.zeros((), device=dev)
    for k, d in enumerate(topology_repr.circulant_shifts(topo)):
        live = (edge_mask[k] if edge_mask is not None
                else torch.ones(n, device=dev))
        total = total + (live * torch.roll(trig, -d)).sum()
    return total
