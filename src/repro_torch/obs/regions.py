"""The program's profiler ranges: ``region(name)`` is a ``torch.profiler``
range ``repro_torch.<name>`` while a profiler records, so the range shares
the profile's clock with the device kernels, and one shared no-op context
otherwise. No switch turns it on: the profiler that an operator or a
benchmark opens does. ``trace.Trace.span`` and the step code open it
(``core.netes``, ``distributed.netes_dist``, ``cuda_watch.device_get``).
"""
from __future__ import annotations

import contextlib
from typing import ContextManager

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
