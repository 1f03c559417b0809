"""The port's contract linter, layer 2 (op contracts): each contract flags
its seeded violation and passes its clean twin
(``tests/_torch_analysis_cases.py``, in a process of its own: the
rank-collective case starts a fake process group), and every registered
entry point passes every contract (``python -m repro_torch.analysis
--strict``, in a subprocess)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))

# case → the rules its run must report (``_torch_analysis_cases.CASES``)
EXPECTED = {
    "item": ["no-host-sync"],
    "copy_to_host": ["no-host-sync"],
    "nonzero": ["no-host-sync"],
    "device_only": [],
    "carry_dtype": ["stable-carry"],
    "carry_host_int": ["stable-carry"],
    "carry_host_int_exempt": [],
    "rank_dependent_collective": ["rank-collective-parity"],
    "same_collectives": [],
    "fused_product": ["fused-seam-product"],
    "rounded_product": [],
    "product_dropped": ["product-ratchet"],
}


@pytest.fixture(scope="module")
def cases():
    res = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_analysis_cases.py")],
        env=ENV, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_each_contract_flags_its_violation_and_passes_its_twin(cases,
                                                                case):
    assert cases[case] == EXPECTED[case]


def test_every_entry_point_passes_every_contract():
    """The 17 entry points of the six hooked modules (the reference's
    names; ``kernels.fused_neighbor_sum.plain`` for its ``.xla``), the
    rank ones once per rank of a fake group of 2 or 5, and the AST layer
    over the port's tree: 0 findings, exit 0."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        env=ENV, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "0 finding(s), 0 suppressed [layer=all, strict]" in res.stdout
