"""The benchmark's files: every cell, configuration, traffic mix, limit
file and per-layer metric that BENCHMARK.json names is found by name, and
the entries keep the benchmark's rules of form."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits the check's time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if "why" in e:
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry, cfg_entry, config, traffic, limits = harness.find_cell(BENCH,
                                                                  cell)
    assert entry["chips"] == 1
    assert cfg_entry["file"].startswith("portbench/configs/")
    assert (harness.ROOT / "runners" / f"{config['runner']}.py").exists()
    assert limits and all(v >= 0 for v in limits.values())
    for key in ("check_broadcast",):
        assert key in traffic


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_metrics(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(BENCH, cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_config_files_are_json_objects():
    for c in BENCH["configs"]:
        data = json.loads((harness.REPO / c["file"]).read_text())
        assert isinstance(data, dict)
        for key in c["reduced"]:
            assert key in data


def test_readers_return_nothing_without_a_trace():
    ctx = {"window": {"metrics": {"rl_iter_ms": 100.0,
                                  "consensus_step_ms": 1000.0},
                      "spans": {}},
           "profile": {"by_name": {}, "busy_s": 0.0, "window_s": 1.0,
                       "kernels": 0, "iters": 8},
           "counts": {"eq3_least_s": 1e-3, "eq3_flops": 1e9,
                      "rollout_flops": 1e9, "step_flops": 1e12}}
    for name in ("rollout_ms.rl", "eq3_ms.rl", "eq3_roofline.rl",
                 "launches_per_iter.rl", "device_idle.rl",
                 "matmul_ms.consensus", "elementwise_ms.consensus",
                 "device_idle.consensus"):
        assert harness.load_module("metrics", name).read(ctx) is None, name
