"""Each cell end to end on the card, as the benchmark's command runs it:
a short window, plain and traced, then ``correct`` and the cell's metrics
in the result line. Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m card portbench
"""
import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_benchmark()


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace",
         str(trace)], cwd=harness.REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    bool(trace))}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
