"""The program's own ranges in a traced run's profile, read per phase.

The port opens a ``torch.profiler`` range ``repro_torch.<name>`` around
each phase of its steps while a profiler records (``obs.trace.region``:
``netes.rollout``, ``netes.mix``, ``consensus.forward``, …), so the
ranges are on the profile's clock with the device's kernels. For each
range name ``read`` gives:

* ``n``: how many ranges of the name;
* ``host_s``: their host time, summed;
* ``kernels``: the device kernels and copies launched inside them: a
  kernel belongs to the innermost program range that holds its launch
  call on the host (the runtime call that the profiler correlates with
  it, not the time the kernel ran);
* ``busy_s``: the union of those kernels' device intervals;
* ``idle_s``: the device's idle time in the traced window whose midpoint
  falls in the range on the host, innermost range first
  (``harness.idle_gaps``, given the ranges in place of the host ops).

Besides, ``unattributed_idle_s`` is the idle time in no program range,
and ``unattributed_busy_s`` and ``unattributed_kernels`` the kernels
launched in none (or whose launch the profile lacks). A range's numbers
are its own, without its children's: the innermost ranges' ``busy_s``
with ``unattributed_busy_s`` make up the window's busy time, up to
overlap between kernels of different ranges.

``from_profile`` takes the events out of a ``torch.profiler`` profile;
``read`` is the arithmetic on them. ``phase(ctx, name)`` is what a metric
reader calls: ``run.py`` hands the readers the profile's summary
(``harness.profile_summary``), not the profile, so ``phase`` reads the
profile that the running ``run.py`` holds on the call stack, once, and
keeps the result in the summary as ``phases``; where the summary already
has ``phases``, it is used as it is. A program without the ranges gives
no range, and its readers nothing; a traced run whose profile cannot be
found raises. The stack walk goes once ``run.py`` stores ``phases`` in
the summary itself (PERF.md section 7).
"""
from __future__ import annotations

import bisect
import re
import sys

from portbench import harness

PREFIX = "repro_torch."
# a host call that hands the device work: a CUDA API call, cuda* or cu*
# (cudaLaunchKernel, cudaLaunchKernelExC, cudaMemcpyAsync, cuLaunchKernel)
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
# ``harness.idle_gaps``' name for a gap in no host op: here, in no range
NO_RANGE = "host python"


def from_profile(prof, span: str = "portbench.window") -> tuple:
    """(ranges, kernels, t0, t1) of a profile: the program's host ranges
    [(name without the prefix, start_us, end_us)], the device kernels and
    copies that start in the window [(launch_us or None, start_us,
    end_us)], and the window ``span``'s bounds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launch_at, device = [], {}, []
    t0 = t1 = None
    for evt in prof.events():
        s, e = float(evt.time_range.start), float(evt.time_range.end)
        if evt.device_type != cuda:
            if evt.name == span:
                t0, t1 = s, e
            elif evt.name.startswith(PREFIX):
                ranges.append((evt.name[len(PREFIX):], s, e))
            elif LAUNCH.match(evt.name):
                launch_at[evt.id] = s
        # the device-side annotation of a host range is not device work
        # (as in ``harness.device_events``)
        elif not (getattr(evt, "is_user_annotation", False)
                  or evt.name.startswith(("portbench.", PREFIX))
                  or e <= s):
            device.append((evt.id, s, e))
    kernels = [(launch_at.get(i), s, e) for i, s, e in device
               if t0 <= s < t1]
    return ranges, kernels, t0, t1


def innermost(ranges) -> tuple:
    """(times, owners): from ``times[k]`` until the next time, the
    innermost of ``ranges`` (index into it) is ``owners[k]``, None where
    none is open. The ranges nest, as one thread's ranges do."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][1], -ranges[i][2]))
    times, owners, stack = [], [], []

    def mark(t, owner):
        if times and times[-1] == t:
            owners[-1] = owner
        else:
            times.append(t)
            owners.append(owner)

    for i in order:
        start = ranges[i][1]
        while stack and ranges[stack[-1]][2] <= start:
            end = ranges[stack.pop()][2]
            mark(end, stack[-1] if stack else None)
        stack.append(i)
        mark(start, i)
    while stack:
        end = ranges[stack.pop()][2]
        mark(end, stack[-1] if stack else None)
    return times, owners


def _owner(times, owners, t):
    k = bisect.bisect_right(times, t) - 1
    return owners[k] if k >= 0 else None


def read(ranges, kernels, t0: float, t1: float) -> dict:
    """Per range name, and the unattributed rest, from ``from_profile``'s
    lists (times in microseconds; the results in seconds)."""
    times, owners = innermost(ranges)
    out = {}
    for name, s, e in ranges:
        row = out.setdefault(name, {"n": 0, "host_s": 0.0, "kernels": 0,
                                    "busy_s": 0.0, "idle_s": 0.0})
        row["n"] += 1
        row["host_s"] += (e - s) * 1e-6
    busy = {}
    for launch, s, e in sorted(kernels, key=lambda k: k[1]):
        i = None if launch is None else _owner(times, owners, launch)
        name = None if i is None else ranges[i][0]
        busy.setdefault(name, []).append((name, s, e))
    for name, events in busy.items():
        if name is not None:
            out[name]["kernels"] = len(events)
            out[name]["busy_s"] = harness.busy_union(events, t0, t1) * 1e-6
    # ``harness.idle_gaps`` names a gap by the latest-starting range that
    # holds its midpoint: with nested ranges in start order, the innermost
    nested = sorted(ranges, key=lambda r: (r[1], -r[2]))
    idle = 0.0
    for name, seconds in harness.idle_gaps(
            sorted(kernels, key=lambda k: k[1]), nested, t0, t1):
        if name == NO_RANGE:
            idle += seconds
        else:
            out[name]["idle_s"] += seconds
    rest = busy.get(None, [])
    return {"ranges": out, "unattributed_idle_s": idle,
            "unattributed_busy_s": harness.busy_union(rest, t0, t1) * 1e-6,
            "unattributed_kernels": len(rest)}


def _profile_on_stack():
    """The ``torch.profiler`` profile that a caller up the stack holds
    (``run.py``'s traced chunk: a local, or a value of a local dict)."""
    import torch
    kind = torch.profiler.profile
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, kind):
                return value
            if isinstance(value, dict):
                for inner in value.values():
                    if isinstance(inner, kind):
                        return inner
        frame = frame.f_back
    return None


def phase(ctx, name: str):
    """The range ``name``'s row of the traced run, or None where the
    profile has no such range. The whole reading is kept in the summary as
    ``phases``, and read from there. Raises where the summary has no
    ``phases`` and no caller holds the profile: the readers' link to the
    traced run is broken, which must not pass as a program without
    ranges."""
    summary = ctx["profile"]
    if "phases" not in summary:
        prof = _profile_on_stack()
        if prof is None:
            raise LookupError("no torch.profiler profile on the call stack "
                              "and no 'phases' in the traced summary")
        summary["phases"] = read(*from_profile(prof))
    return summary["phases"]["ranges"].get(name)
