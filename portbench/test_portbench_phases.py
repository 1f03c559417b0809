"""``phases.py``: the program's ranges read from a profile. Its arithmetic
on synthetic events (nesting, attribution of a kernel by its launch,
idle gaps by their midpoint, the unattributed rest), its reading of a
profile's events, the harness's summary unchanged by program ranges, the
readers of the per-phase metrics, a CPU profile of the program's own
ranges, and on the card a traced ER chunk whose phases make up its busy
time."""
import types

import pytest
import torch

from portbench import harness, phases
from portbench.runners import netes_rl
from portbench.test_portbench_cells import tiny_rl

BENCH = harness.load_benchmark()
READERS = ("rollout_busy_ms.rl", "rollout_idle_ms.rl", "rollout_launches.rl",
           "loop_idle_ms.rl", "mix_ms.rl", "forward_ms.consensus",
           "perturb_ms.consensus", "update_ms.consensus", "draw_ms.rl",
           "perturb_ms.rl", "shape_ms.rl", "broadcast_ms.rl",
           "drain_idle_ms.rl", "unattributed_idle_ms.rl",
           "members_idle_ms.consensus", "unattributed_idle_ms.consensus")

# host ranges and kernels (launch, start, end) in microseconds, in a window
# [0, 130]; see each kernel's comment for where it belongs
RANGES = [("netes.step", 0.0, 100.0), ("netes.rollout", 10.0, 50.0),
          ("netes.mix", 60.0, 80.0), ("netes.step", 100.0, 120.0)]
KERNELS = [(20.0, 22.0, 40.0),     # rollout
           (30.0, 38.0, 48.0),     # rollout, overlapping the first
           (5.0, 50.0, 52.0),      # step: launched before the rollout
           (70.0, 72.0, 90.0),     # mix, running past the range's end
           (None, 95.0, 97.0),     # no launch in the profile
           (110.0, 111.0, 115.0),  # the second step
           (125.0, 126.0, 128.0)]  # launched in no range


def test_innermost_owner_of_each_stretch():
    times, owners = phases.innermost(RANGES)
    assert times == [0.0, 10.0, 50.0, 60.0, 80.0, 100.0, 120.0]
    assert owners == [0, 1, 0, 2, 0, 3, None]


def test_read_attributes_by_launch_and_by_gap_midpoint():
    got = phases.read(RANGES, KERNELS, 0.0, 130.0)
    us = pytest.approx
    r = got["ranges"]
    assert set(r) == {"netes.step", "netes.rollout", "netes.mix"}
    assert r["netes.step"]["n"] == 2
    assert r["netes.step"]["host_s"] == us(120e-6)
    assert (r["netes.rollout"]["kernels"], r["netes.step"]["kernels"],
            r["netes.mix"]["kernels"]) == (2, 2, 1)
    # busy: the union of each range's own kernels
    assert r["netes.rollout"]["busy_s"] == us(26e-6)
    assert r["netes.step"]["busy_s"] == us(6e-6)
    assert r["netes.mix"]["busy_s"] == us(18e-6)
    # idle gaps [0,22] [48,50] -> rollout; [52,72] -> mix; [90,95]
    # [97,111] -> step; [115,126] [128,130] -> none
    assert r["netes.rollout"]["idle_s"] == us(24e-6)
    assert r["netes.mix"]["idle_s"] == us(20e-6)
    assert r["netes.step"]["idle_s"] == us(19e-6)
    assert got["unattributed_idle_s"] == us(13e-6)
    assert got["unattributed_busy_s"] == us(4e-6)
    assert got["unattributed_kernels"] == 2
    busy = sum(v["busy_s"] for v in r.values()) + got["unattributed_busy_s"]
    idle = sum(v["idle_s"] for v in r.values()) + got["unattributed_idle_s"]
    assert busy + idle == us(130e-6)


def test_read_without_program_ranges():
    got = phases.read([], KERNELS, 0.0, 130.0)
    assert got["ranges"] == {} and got["unattributed_kernels"] == 7
    assert got["unattributed_busy_s"] + got["unattributed_idle_s"] == \
        pytest.approx(130e-6)


def _event(name, start, end, device=False, eid=0, annotation=False):
    dev = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=eid, is_user_annotation=annotation,
        device_type=dev.CUDA if device else dev.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _fake_profile(program_ranges: bool):
    """A profile's events: the window, aten ops and their launches, the
    kernels, and with ``program_ranges`` the program's host ranges with
    their device-side annotations. Ids: a launch shares its kernel's; an
    aten op's may collide with a launch's, as the profiler's do."""
    evts = [_event("portbench.window", 0.0, 130.0, annotation=True),
            _event("aten::mul", 20.0, 32.0, eid=7),
            _event("cudaLaunchKernel", 21.0, 23.0, eid=7),
            _event("cudaLaunchKernelExC", 30.0, 31.0, eid=8),
            _event("cudaMemcpyAsync", 70.0, 71.0, eid=9),
            _event("Lazy Function Loading", 71.0, 72.0, eid=10),
            _event("gemv", 22.0, 40.0, device=True, eid=7),
            _event("mixing_gemm", 38.0, 48.0, device=True, eid=8),
            _event("Memcpy DtoH", 72.0, 90.0, device=True, eid=9),
            _event("early", -5.0, -1.0, device=True, eid=11)]
    if program_ranges:
        evts += [_event("repro_torch.netes.rollout", 10.0, 50.0,
                        annotation=True, eid=3),
                 _event("repro_torch.netes.mix", 60.0, 80.0,
                        annotation=True, eid=4),
                 _event("repro_torch.netes.rollout", 22.0, 48.0,
                        device=True, annotation=True, eid=3)]
    return types.SimpleNamespace(events=lambda: evts)


def test_from_profile_takes_launches_by_correlation():
    ranges, kernels, t0, t1 = phases.from_profile(_fake_profile(True))
    assert (t0, t1) == (0.0, 130.0)
    assert sorted(ranges) == [("netes.mix", 60.0, 80.0),
                              ("netes.rollout", 10.0, 50.0)]
    # the annotation and the kernel before the window are left out; the
    # aten op sharing the launch's id does not stand for it
    assert sorted(kernels) == [(21.0, 22.0, 40.0), (30.0, 38.0, 48.0),
                               (70.0, 72.0, 90.0)]
    got = phases.read(ranges, kernels, t0, t1)["ranges"]
    assert got["netes.rollout"]["kernels"] == 2
    assert got["netes.mix"]["kernels"] == 1


def test_profile_summary_keeps_its_readings_beside_program_ranges():
    plain = harness.profile_summary(_fake_profile(False))
    ranged = harness.profile_summary(_fake_profile(True))
    assert set(ranged) == set(plain)
    assert set(ranged["breakdown"]) == set(plain["breakdown"])
    for key in ("busy_s", "window_s", "by_name", "kernels"):
        assert ranged[key] == plain[key], key


def _ctx(found=None):
    ctx = {"window": {"metrics": {"rl_iter_ms": 100.0,
                                  "consensus_step_ms": 1000.0},
                      "spans": {}},
           "profile": {"by_name": {}, "busy_s": 50e-6, "window_s": 130e-6,
                       "kernels": 7, "iters": 2},
           "counts": {}}
    if found is not None:
        ctx["profile"]["phases"] = found
    return ctx


def test_readers_return_nothing_without_program_ranges():
    """A program without the ranges (the parent of the regions): its
    profile, read from the summary or found on the stack, gives no
    range, and every reader nothing."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            torch.ones(4).add_(1.0)
    for ctx in (_ctx(), _ctx(phases.read([], KERNELS, 0.0, 130.0))):
        for name in READERS:
            assert harness.load_module("metrics", name).read(ctx) is None, \
                name
    assert prof is not None     # the profile a caller holds, as run.py


def test_readers_raise_where_the_profile_is_lost():
    """No ``phases`` in the summary and no profile up the stack: the link
    to the traced run is broken, and a reader says so."""
    for name in READERS:
        with pytest.raises(LookupError):
            harness.load_module("metrics", name).read(_ctx())


def test_readers_of_the_rl_phases():
    found = phases.read(RANGES, KERNELS, 0.0, 130.0)
    ctx = _ctx(found)

    def value(name):
        return harness.load_module("metrics", name).read(ctx)
    assert value("rollout_busy_ms.rl") == pytest.approx(26e-3 / 2)
    assert value("rollout_idle_ms.rl") == pytest.approx(24e-3 / 2)
    assert value("rollout_launches.rl") == 1.0
    assert value("mix_ms.rl") == pytest.approx(18e-3 / 2)
    assert value("loop_idle_ms.rl") == pytest.approx((80e-6 - 24e-6)
                                                     * 1e3 / 2)
    assert value("unattributed_idle_ms.rl") == pytest.approx(13e-3 / 2)
    # the drain: the gap [52, 72] now falls in it, not in the mix
    drained = _ctx(phases.read(RANGES + [("obs.device_get", 61.0, 66.0)],
                               KERNELS, 0.0, 130.0))
    assert harness.load_module("metrics", "drain_idle_ms.rl").read(
        drained) == pytest.approx(20e-3 / 2)
    for name in ("draw_ms.rl", "perturb_ms.rl", "shape_ms.rl",
                 "broadcast_ms.rl", "drain_idle_ms.rl",
                 "forward_ms.consensus",
                 "perturb_ms.consensus", "update_ms.consensus",
                 "members_idle_ms.consensus",
                 "unattributed_idle_ms.consensus"):
        assert value(name) is None, name


@pytest.mark.parametrize("phase, metric", [
    ("netes.draw", "draw_ms.rl"), ("netes.perturb", "perturb_ms.rl"),
    ("netes.shape", "shape_ms.rl"), ("netes.broadcast", "broadcast_ms.rl")])
def test_busy_readers_of_the_other_rl_phases(phase, metric):
    """Each phase's own kernels: a kernel launched in the phase, inside
    the step, counts for it; one launched in the step outside it does
    not."""
    ranges = [("netes.step", 0.0, 100.0), (phase, 10.0, 30.0)]
    kernels = [(12.0, 14.0, 24.0), (20.0, 26.0, 30.0), (40.0, 41.0, 60.0)]
    ctx = _ctx(phases.read(ranges, kernels, 0.0, 100.0))
    got = harness.load_module("metrics", metric).read(ctx)
    assert got == pytest.approx(14e-3 / 2)    # [14, 24] and [26, 30]


def test_readers_of_the_consensus_phases():
    ranges = [("consensus.step", 0.0, 100.0),
              ("consensus.members", 5.0, 60.0),
              ("consensus.perturb", 10.0, 20.0),
              ("consensus.forward", 20.0, 50.0),
              ("consensus.update", 60.0, 90.0)]
    kernels = [(11.0, 12.0, 22.0),    # perturb
               (21.0, 24.0, 45.0),    # forward; gap [22, 24] -> forward
               (55.0, 56.0, 58.0),    # members' own; gap [45, 56] -> members
               (62.0, 70.0, 95.0)]    # update; gap [58, 70] -> update
    found = phases.read(ranges, kernels, 0.0, 110.0)
    ctx = _ctx(found)
    r = found["ranges"]

    def value(name):
        return harness.load_module("metrics", name).read(ctx)
    assert value("perturb_ms.consensus") == pytest.approx(10e-3 / 2)
    assert value("forward_ms.consensus") == pytest.approx(21e-3 / 2)
    # idle: [0, 12] mid 6 -> members, [22, 24] -> forward, [45, 56] ->
    # members, [58, 70] -> update, [95, 110] mid 102.5 -> none
    assert r["consensus.members"]["idle_s"] == pytest.approx(23e-6)
    assert value("members_idle_ms.consensus") == pytest.approx(25e-3 / 2)
    assert value("unattributed_idle_ms.consensus") == pytest.approx(
        15e-3 / 2)
    assert value("unattributed_idle_ms.rl") is None


def test_new_readers_are_listed_where_they_read():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        cells = (["jamba.consensus.er"] if name.endswith(".consensus")
                 else ["pendulum.er.n16384", "pendulum.fc.n16384"])
        assert m["workloads"] == cells


def _traced_cpu_chunk(run):
    """A chunk under a CPU profile, as the runner's ``traced`` takes one on
    the card."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            run._chunk()
    return prof


def test_the_programs_ranges_in_a_cpu_profile():
    """The tiny ER cell's chunk on the CPU: every phase of the step once
    an iteration, the drain once, and the readers find the profile that a
    caller holds (a CPU profile has no device kernels: the busy time is
    0)."""
    config, traffic, _ = tiny_rl("pendulum.er.n16384")
    run = netes_rl.Run(config, traffic, 5, "cpu")
    traced = {"prof": _traced_cpu_chunk(run), "iters":
              traffic["drain_chunk"]}
    found = phases.read(*phases.from_profile(traced["prof"]))["ranges"]
    iters = traffic["drain_chunk"]
    assert {k: v["n"] for k, v in found.items()} == {
        "netes.step": iters, "netes.draw": iters, "netes.perturb": iters,
        "netes.rollout": iters, "netes.shape": iters, "netes.mix": iters,
        "netes.broadcast": iters, "obs.device_get": 1}
    ctx = _ctx()
    ctx["profile"]["iters"] = traced["iters"]
    reader = harness.load_module("metrics", "rollout_busy_ms.rl")
    assert reader.read(ctx) == 0.0
    assert ctx["profile"]["phases"]["ranges"] == found


@pytest.mark.card
def test_phases_make_up_the_busy_time_of_an_er_chunk(card):
    """On the card, the ER cell's traced chunk: the innermost ranges' busy
    time with the unattributed kernels' is the profile's busy time within
    1%, and every phase of the step shows once an iteration."""
    _, _, config, traffic, _ = harness.find_cell(BENCH, "pendulum.er.n16384")
    run = netes_rl.Run(config, traffic, 2 ** 31 + 91, card)
    traced = run.traced()
    summary = harness.profile_summary(traced["prof"])
    found = phases.read(*phases.from_profile(traced["prof"]))
    busy = (sum(v["busy_s"] for v in found["ranges"].values())
            + found["unattributed_busy_s"])
    assert busy == pytest.approx(summary["busy_s"], rel=0.01)
    for name in ("step", "draw", "perturb", "rollout", "shape", "mix",
                 "broadcast"):
        assert found["ranges"][f"netes.{name}"]["n"] == traced["iters"]
    assert found["ranges"]["netes.rollout"]["kernels"] > 0
