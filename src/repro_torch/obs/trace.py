"""Structured JSONL run traces (DESIGN.md §15). The port of
``repro.obs.trace``, with the same schema.

One trace = one append-only JSONL file. Line 1 is a schema-versioned
``meta`` record; every following line is a ``span`` or ``event`` record:

    {"kind": "meta", "schema": "repro.trace/v1", "name": ..., env...}
    {"kind": "span", "name": "chunk", "t0": ..., "dur_s": ...,
     "compiles": 0, "transfers": 1, "attrs": {...}}
    {"kind": "event", "name": "eval", "t": ..., "attrs": {...}}

Spans are host-time intervals stamped with the kernel builds (``compiles``:
nvcc runs and library loads, ``obs.cuda_watch``) and host transfers
(``transfers``: calls of ``cuda_watch.device_get``) that occurred INSIDE
the span, so "which chunk built a kernel" and "which drain transferred
twice" are greppable facts. Spans may nest; each line is self-contained
(``depth`` records nesting). The writer never touches device values
itself: it records host-side timing only. The meta line names the
environment: ``torch``, ``cuda`` (the toolkit torch was built with, or
None), ``backend`` (``"gpu"``/``"cpu"``), ``devices`` and ``device_name``.

A span's ``t0`` is the epoch time it opened; its ``dur_s`` is host time
(``time.perf_counter``): how long the host took to enqueue the span's
work, not how long the device ran it. Device time per span comes from a
``torch.profiler`` profile: ``Trace.span`` opens ``regions.region(name)``
around its body, a ``record_function`` range ``repro_torch.<name>`` while
a profiler records (so on the profile's clock with the device kernels),
and a no-op otherwise.

``validate_trace`` is the schema gate (``python -m repro_torch.obs
validate <file>``); ``summarize`` renders a per-span table.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from . import cuda_watch
from .regions import region

SCHEMA = "repro.trace/v1"

_META_REQUIRED = ("kind", "schema", "name")
_SPAN_REQUIRED = ("kind", "name", "t0", "dur_s", "depth",
                  "compiles", "transfers")
_EVENT_REQUIRED = ("kind", "name", "t")

def _environment(device: Optional[Union[str, torch.device]]
                 ) -> Dict[str, Any]:
    """The meta line's environment keys for a run on ``device`` (None: the
    GPU when there is one)."""
    if device is None:
        gpu = torch.cuda.is_available()
        dev = torch.device("cuda" if gpu else "cpu")
    else:
        dev = torch.device(device)
        gpu = dev.type == "cuda"
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "backend": "gpu" if gpu else "cpu",
            "devices": torch.cuda.device_count() if gpu else 1,
            "device_name": (torch.cuda.get_device_name(dev) if gpu
                            else "cpu")}


class Trace:
    """Append-only JSONL trace writer. Use as a context manager::

        with Trace(path, name="fleet-pulse") as tr:
            with tr.span("warmup"):
                ...
            tr.event("eval", score=1.2)

    Lines are flushed per record (a crashed run keeps its prefix; every
    prefix is a valid trace). ``Trace(None)`` is a no-op writer so call
    sites thread ``trace`` unconditionally. ``device`` is the run's device,
    for the meta line.
    """

    def __init__(self, path: Optional[Union[str, pathlib.Path]],
                 name: str = "run", *,
                 device: Optional[Union[str, torch.device]] = None,
                 **meta: Any) -> None:
        self.path = pathlib.Path(path) if path is not None else None
        self._fh = None
        self._depth = 0
        self._watch = None
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w")
        self._watch = cuda_watch.Watch().start()
        self._write({"kind": "meta", "schema": SCHEMA, "name": name,
                     "t0": time.time(), **_environment(device), **meta})

    # -- lifecycle --------------------------------------------------------
    @property
    def active(self) -> bool:
        return self._fh is not None

    def close(self) -> None:
        if self._fh is not None:
            self._watch.stop()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- records ----------------------------------------------------------
    def _write(self, rec: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        """Host-time span stamped with the kernel builds and host
        transfers that happened inside it, and ``region(name)`` around
        its body, written or not."""
        with region(name):
            if self._fh is None:
                yield
                return
            c0, x0 = self._watch.snapshot()
            t0, p0 = time.time(), time.perf_counter()
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                c1, x1 = self._watch.snapshot()
                rec = {"kind": "span", "name": name, "t0": t0,
                       "dur_s": time.perf_counter() - p0,
                       "depth": self._depth,
                       "compiles": c1 - c0, "transfers": x1 - x0}
                if attrs:
                    rec["attrs"] = attrs
                self._write(rec)

    def event(self, name: str, **attrs: Any) -> None:
        if self._fh is None:
            return
        rec: Dict[str, Any] = {"kind": "event", "name": name,
                               "t": time.time()}
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)


# ---------------------------------------------------------------------------
# readers — schema validation + summary (the ``python -m repro_torch.obs``
# CLI)
# ---------------------------------------------------------------------------

def read_trace(path: Union[str, pathlib.Path]) -> List[Dict[str, Any]]:
    recs = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
    return recs


def validate_trace(path: Union[str, pathlib.Path]) -> List[str]:
    """Schema gate: returns a list of violations (empty = valid)."""
    errors: List[str] = []
    try:
        recs = read_trace(path)
    except ValueError as e:
        return [str(e)]
    if not recs:
        return [f"{path}: empty trace"]
    meta = recs[0]
    if meta.get("kind") != "meta":
        errors.append(f"line 1: first record must be kind=meta, "
                      f"got {meta.get('kind')!r}")
    elif meta.get("schema") != SCHEMA:
        errors.append(f"line 1: schema {meta.get('schema')!r} != {SCHEMA!r}")
    for missing in (k for k in _META_REQUIRED if k not in meta):
        errors.append(f"line 1: meta missing key {missing!r}")
    for i, rec in enumerate(recs[1:], start=2):
        kind = rec.get("kind")
        if kind == "span":
            req = _SPAN_REQUIRED
        elif kind == "event":
            req = _EVENT_REQUIRED
        elif kind == "meta":
            errors.append(f"line {i}: duplicate meta record")
            continue
        else:
            errors.append(f"line {i}: unknown kind {kind!r}")
            continue
        for k in req:
            if k not in rec:
                errors.append(f"line {i}: {kind} missing key {k!r}")
        for k in ("t0", "dur_s", "t"):
            if k in rec and not isinstance(rec[k], (int, float)):
                errors.append(f"line {i}: {k} must be a number")
        for k in ("compiles", "transfers", "depth"):
            if k in rec and (not isinstance(rec[k], int) or rec[k] < 0):
                errors.append(f"line {i}: {k} must be a non-negative int")
    return errors


def summarize(path: Union[str, pathlib.Path]) -> str:
    """Per-span-name aggregate: count, total wall, compiles, transfers."""
    recs = read_trace(path)
    meta = recs[0] if recs and recs[0].get("kind") == "meta" else {}
    spans: Dict[str, Dict[str, float]] = {}
    events = 0
    for rec in recs[1:]:
        if rec.get("kind") == "event":
            events += 1
            continue
        if rec.get("kind") != "span":
            continue
        agg = spans.setdefault(rec["name"], {"n": 0, "wall_s": 0.0,
                                             "compiles": 0, "transfers": 0})
        agg["n"] += 1
        agg["wall_s"] += rec.get("dur_s", 0.0)
        agg["compiles"] += rec.get("compiles", 0)
        agg["transfers"] += rec.get("transfers", 0)
    lines = [f"trace {meta.get('name', '?')} — schema "
             f"{meta.get('schema', '?')}, torch {meta.get('torch', '?')}, "
             f"{meta.get('backend', '?')} {meta.get('device_name', '?')}, "
             f"{meta.get('devices', '?')} device(s)"]
    lines.append(f"{'span':<16}{'n':>6}{'wall_s':>10}{'compiles':>10}"
                 f"{'transfers':>11}")
    for name in sorted(spans):
        a = spans[name]
        lines.append(f"{name:<16}{a['n']:>6}{a['wall_s']:>10.3f}"
                     f"{a['compiles']:>10}{a['transfers']:>11}")
    lines.append(f"{events} event(s), {len(recs) - 1} record(s)")
    return "\n".join(lines)
