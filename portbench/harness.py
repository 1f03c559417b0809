"""What every cell shares: finding a cell's files by name, the seeded
draws, the comparison's arithmetic, the profiler's reading and the result
line.

Nothing here imports the program; the runners do.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / ".cache"

# Top-level module names no run may hold: the JAX stack and the JAX
# package the port was made from (compared whole: the port's name begins
# with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> None:
    """Fixed cache directories inside the checkout, and no JAX for
    libraries that would load it by themselves."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str):
    """(cell, config entry, config file, traffic file, limits file) of the
    workload ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / entry["file"]).read_text())
    return (cell, entry, config, load_json("traffic", cell["traffic"]),
            load_json("limits", name))


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end
    metrics, or with ``trace`` its per-layer metrics."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_loaded() -> list:
    return sorted(n for n in sys.modules
                  if n.split(".")[0] in FORBIDDEN_MODULES)


# --------------------------------------------------------------------------
# seeds
# --------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def sub_seed(*parts: int) -> int:
    """A 63-bit generator seed from integer parts (SplitMix64's finalizer,
    chained); any whole number, negative or past 64 bits, is folded in."""
    h = 0x243F6A8885A308D3
    for part in parts:
        x = (h ^ (int(part) & _M64)) & _M64
        x = (x + 0x9E3779B97F4A7C15) & _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        h = x ^ (x >> 31)
    return h >> 1


def generator(device, *parts: int):
    import torch
    return torch.Generator(device=device).manual_seed(sub_seed(*parts))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_betas(pattern, p_broadcast: float, seed: int, device) -> list:
    """β of each checked step, drawn from the seed within the side of
    p_b that ``pattern`` names (True: the step broadcasts), so that every
    seed's check covers Eq. 3 and the broadcast."""
    import torch
    u = torch.rand(len(pattern), generator=generator(device, seed, 7),
                   device=device, dtype=torch.float64).tolist()
    return [ui * p_broadcast if b else p_broadcast + ui * (1 - p_broadcast)
            for ui, b in zip(u, pattern, strict=True)]


# --------------------------------------------------------------------------
# the comparison's arithmetic
# --------------------------------------------------------------------------

def norm_gaps(prog_norms: list, ref_norms: list) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's. Leaves whose reference norm is under a thousandth of
    the median leaf's (round-off alone moves them) are left out."""
    med = statistics.median(ref_norms)
    worst = 0.0
    for p, r in zip(prog_norms, ref_norms, strict=True):
        if r < 1e-3 * med:
            continue
        worst = max(worst, abs(p - r) / max(r, med))
    return worst


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, failed names): every compared number at or under its
    limit; a number that is not finite fails."""
    failed = [k for k, lim in limits.items()
              if not (numbers.get(k, float("nan")) <= lim)]
    return not failed, failed


# --------------------------------------------------------------------------
# the profiler
# --------------------------------------------------------------------------

def device_events(prof) -> list:
    """(name, start_us, end_us) of every device kernel or copy in a
    ``torch.profiler`` trace, in start order. A host range (a
    ``record_function``) also shows on the device's timeline as a user
    annotation spanning its kernels: those are not device work."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for evt in prof.events():
        if (evt.device_type != cuda
                or getattr(evt, "is_user_annotation", False)
                or evt.name.startswith("portbench.")
                or evt.time_range.end <= evt.time_range.start):
            continue
        out.append((evt.name, float(evt.time_range.start),
                    float(evt.time_range.end)))
    out.sort(key=lambda e: e[1])
    return out


def host_ops(prof) -> list:
    """(name, start_us, end_us) of every host op in the trace."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    return sorted(((e.name, float(e.time_range.start),
                    float(e.time_range.end)) for e in prof.events()
                   if e.device_type == cpu), key=lambda e: e[1])


def busy_union(events, t0: float, t1: float) -> float:
    """Microseconds of [t0, t1] in which some device event ran."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(events, ops, t0: float, t1: float) -> list:
    """Device idle gaps in [t0, t1], each named by the innermost host op
    running at the gap's midpoint ("host python" where none ran):
    [(name, seconds summed over its gaps)], longest first."""
    gaps, last = [], t0
    for _, s, e in events:
        if s > last:
            gaps.append((last, min(s, t1)))
        last = max(last, e)
        if last >= t1:
            break
    if last < t1:
        gaps.append((last, t1))
    starts = [o[1] for o in ops]
    import bisect
    by_name: dict = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        name = "host python"
        # the innermost op holding the midpoint: the latest-starting one
        for j in range(i - 1, max(i - 4000, -1), -1):
            if ops[j][2] >= mid:
                name = ops[j][0]
                break
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def profile_summary(prof, span: str = "portbench.window") -> dict:
    """The traced window's device reading (the window: the host range
    ``span`` that the runner recorded around it): busy and window
    seconds, device time by kernel name, kernel count, and the
    breakdown."""
    ops = host_ops(prof)
    t0_us, t1_us = next((s, e) for n, s, e in ops if n == span)
    events = device_events(prof)
    kernels = [e for e in events if t0_us <= e[1] < t1_us]
    by_name: dict = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = busy_union(kernels, t0_us, t1_us) * 1e-6
    gaps = idle_gaps(kernels, [o for o in ops if o[0] != span], t0_us,
                     t1_us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": (t1_us - t0_us) * 1e-6,
            "by_name": by_name, "kernels": len(kernels),
            "breakdown": {"device_ops": [[n, s] for n, s in top[:10]],
                          "idle_gaps": [[n, s] for n, s in gaps[:10]]}}


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------

def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def print_checks(numbers: dict, limits: dict) -> None:
    for k, lim in limits.items():
        print(f"check {k} = {numbers.get(k)!r} limit {lim!r}",
              file=sys.stderr)
    sys.stderr.flush()
