"""Kernel-build and host-transfer counters (DESIGN.md §15): the port's
counterpart of ``repro.obs.xla_watch``.

Two kinds of event:

* kernel builds — the port compiles nothing but its CUDA kernels, so a
  "compile" is one kernel library made ready by ``kernels/_build.py``: one
  nvcc run of ``build_all``, or one ctypes load of a library by
  ``CudaKernel._load``. Both call :func:`report_build`. A warmed run
  builds nothing, so a span of it counts 0.
* host transfers — one call of :func:`device_get`, the port's sanctioned
  drain: the loop's metrics and eval scores and ``Probes.drain`` leave the
  device through it, one copy per call whatever the payload. The count is
  "explicit drains", not copies: a stray ``.item()`` or ``float()`` of a
  device tensor bypasses it, and shows up as a MISSING count against an
  expected one (``chip_smoke.py``'s sync check catches those on the card).

``count_kernel_builds`` and ``count_host_transfers`` are context managers
yielding a list that grows by one per event, so ``len(...)`` is the count.
``Watch`` is the persistent variant the JSONL trace writer uses to stamp
each span with the builds and transfers inside it. Hooks are a list of
callbacks under a lock, so watchers nest and compose.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Sequence, Tuple, Union

import torch

from .regions import region

_lock = threading.Lock()
_build_callbacks: List[Callable[[str], None]] = []
_transfer_callbacks: List[Callable[[], None]] = []
_kernel_callbacks: List[Callable[[str, float, float], None]] = []


def _add(callbacks: list, cb) -> None:
    with _lock:
        callbacks.append(cb)


def _remove(callbacks: list, cb) -> None:
    with _lock:
        callbacks.remove(cb)


def report_build(what: str) -> None:
    """One kernel library built or loaded (``kernels/_build.py``)."""
    for cb in list(_build_callbacks):
        cb(what)


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """One kernel call's work, from its wrapper: the dot FLOPs its plain
    version does and the bytes it must move. Made where the wrapper
    launches its kernel and on its shape-only path (fake and meta
    tensors), which launches nothing; ``launch.op_costs`` listens, since
    a ctypes launch passes no dispatcher."""
    for cb in list(_kernel_callbacks):
        cb(name, float(flops), float(nbytes))


@contextlib.contextmanager
def on_kernel_report(cb: Callable[[str, float, float], None]
                     ) -> Iterator[None]:
    """``cb(name, flops, nbytes)`` is called for every kernel report made
    while the context is active."""
    _add(_kernel_callbacks, cb)
    try:
        yield
    finally:
        _remove(_kernel_callbacks, cb)


Payload = Union[torch.Tensor, Sequence[torch.Tensor]]


def device_get(payload: Payload) -> Union[torch.Tensor,
                                          Tuple[torch.Tensor, ...]]:
    """The payload on the host in ONE copy, counted as one transfer: a
    tensor comes back as its ``.cpu()``; a tuple or list of tensors on one
    device is viewed as bytes, concatenated on the device, copied once and
    split back into a tuple of host tensors of the original dtypes and
    shapes (bit for bit). A profile shows it as ``obs.device_get``."""
    for cb in list(_transfer_callbacks):
        cb()
    with region("obs.device_get"):
        if isinstance(payload, torch.Tensor):
            return payload.detach().cpu()
        parts = [t.detach().contiguous() for t in payload]
        if not parts:
            return ()
        flat = torch.cat([t.reshape(-1).view(torch.uint8)
                          for t in parts]).cpu()
        out, at = [], 0
        for t in parts:
            size = t.numel() * t.element_size()
            # a clone starts at offset 0, as a view to a wider dtype needs
            out.append(flat[at:at + size].clone().view(t.dtype)
                       .reshape(t.shape))
            at += size
        return tuple(out)


@contextlib.contextmanager
def count_kernel_builds() -> Iterator[List[str]]:
    """Yields a list that grows by one per kernel library built or loaded
    while the context is active: a warmed run must add none."""
    counts: List[str] = []
    cb = counts.append
    _add(_build_callbacks, cb)
    try:
        yield counts
    finally:
        _remove(_build_callbacks, cb)


@contextlib.contextmanager
def count_host_transfers() -> Iterator[List[str]]:
    """Yields a list that grows by one per :func:`device_get` call made
    while the context is active — the single-transfer-per-drain gate."""
    counts: List[str] = []

    def cb():
        counts.append("device_get")

    _add(_transfer_callbacks, cb)
    try:
        yield counts
    finally:
        _remove(_transfer_callbacks, cb)


class Watch:
    """Persistent build+transfer counter for span-structured tracing.

    ``start()`` installs both hooks; ``snapshot()`` returns monotonic
    ``(compiles, transfers)`` totals so a span records deltas around its
    body; ``stop()`` uninstalls. Used by ``repro_torch.obs.trace.Trace``.
    """

    def __init__(self) -> None:
        self.compiles = 0
        self.transfers = 0
        self._active = False

    def _on_build(self, what: str) -> None:
        self.compiles += 1

    def _on_transfer(self) -> None:
        self.transfers += 1

    def start(self) -> "Watch":
        if not self._active:
            _add(_build_callbacks, self._on_build)
            _add(_transfer_callbacks, self._on_transfer)
            self._active = True
        return self

    def snapshot(self) -> Tuple[int, int]:
        return self.compiles, self.transfers

    def stop(self) -> None:
        if self._active:
            _remove(_build_callbacks, self._on_build)
            _remove(_transfer_callbacks, self._on_transfer)
            self._active = False
