"""The program's profiler ranges: ``region(name)`` is a ``torch.profiler``
range ``repro_torch.<name>`` while a profiler records, so the range shares
the profile's clock with the device kernels, and one shared no-op context
otherwise. No switch turns it on: the profiler that an operator or a
benchmark opens does. ``trace.Trace.span`` and the step code open it
(``core.netes``, ``distributed.netes_dist``, ``cuda_watch.device_get``).

``count(name, value)`` adds ``value()``, a device tensor, to the counter
``name``, under the same rule: only while a profiler records; otherwise
``value`` is not called, so an untimed step launches nothing for the
counter and reads nothing back. ``counters()`` returns the totals
as host numbers (one read of the device) and ``reset_counters()`` clears
them; a caller reads them after the profiled step
(``models.moe.moe_block``'s dropped choices).
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict

import torch

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def region(name: str) -> ContextManager:
    """A ``torch.profiler`` range ``repro_torch.<name>`` while a profiler
    records, else one shared no-op context. Host-side only: it reads
    nothing from the device. Off, it calls no ``record_function``, which
    would cost far more than the check and, under a dispatch mode such as
    ``launch.op_costs.OpCosts``, add an op to the step's list."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


_COUNTERS: Dict[str, torch.Tensor] = {}


def count(name: str, value: Callable) -> None:
    """Add ``value()`` (a 0-d device tensor or a number) to the counter
    ``name`` while a profiler records; else nothing, and ``value`` is not
    called. No host read."""
    if not torch.autograd._profiler_enabled():
        return
    value = value()
    if name in _COUNTERS:
        _COUNTERS[name] = _COUNTERS[name] + value
    else:
        _COUNTERS[name] = torch.as_tensor(value, dtype=torch.float64)


def counters() -> Dict[str, float]:
    """The counters' totals, read to the host."""
    return {k: float(v) for k, v in _COUNTERS.items()}


def reset_counters() -> None:
    _COUNTERS.clear()
