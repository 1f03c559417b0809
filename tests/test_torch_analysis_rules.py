"""The port's contract linter, layer 1 (AST): every rule fires on exactly
its seeded-violation fixture (``tests/fixtures/analysis_torch/``), stays
silent on the clean twin and on the port's own tree, the findings module
(a copy of the reference's) reads and renders the reference's fixtures
as the reference's does, and the CLI lists the port's rules and entry
points."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import findings as ref_findings
from repro_torch.analysis import findings
from repro_torch.analysis.ast_rules import RULES, run_rules
from repro_torch.analysis.cli import _default_paths

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
REF_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
RULE_IDS = sorted(RULES)


def _slug(rule_id: str) -> str:
    return rule_id.replace("-", "_")


def test_the_rules_are_the_references_re_aimed():
    """Four of the reference's five rules, renamed for eager PyTorch;
    ``pallas-literal-index`` has no counterpart (no Pallas in the port)."""
    assert RULE_IDS == ["global-rng", "host-sync-in-step", "implicit-dtype",
                        "tensor-branch-in-step"]
    for rid in RULE_IDS:
        assert (FIXTURES / f"bad_{_slug(rid)}.py").is_file(), rid
        assert (FIXTURES / f"clean_{_slug(rid)}.py").is_file(), rid


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_exactly_once_on_its_bad_fixture(rule_id):
    found = run_rules([FIXTURES / f"bad_{_slug(rule_id)}.py"])
    assert [f.rule for f in found] == [rule_id], found
    assert found[0].line > 0 and found[0].hint and not found[0].suppressed


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rules_are_silent_on_the_clean_fixture(rule_id):
    assert run_rules([FIXTURES / f"clean_{_slug(rule_id)}.py"]) == []


def test_the_ports_tree_lints_clean():
    """``src/repro_torch``, ``examples/*_torch.py`` and ``chip_smoke.py``:
    no unsuppressed finding, and every suppression carries its reason."""
    paths = _default_paths()
    assert REPO / "chip_smoke.py" in paths
    assert any(p.name.endswith("_torch.py") for p in paths)
    found = run_rules(paths)
    live = [f.render() for f in found if not f.suppressed]
    assert live == []
    assert all(f.justification for f in found if f.suppressed)


@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           REF_FIXTURES.glob("*.py")))
def test_findings_read_the_references_fixtures_as_the_reference(fixture):
    """The suppression scan of every reference fixture, and the rendering
    of a finding on each of its lines, suppressed or not, equal the
    reference's."""
    src = (REF_FIXTURES / fixture).read_text()
    assert findings.scan_suppressions(src) == \
        ref_findings.scan_suppressions(src)
    for line in range(1, src.count("\n") + 2):
        args = dict(rule="host-sync-in-trace", path=fixture, line=line,
                    message="m", hint="h")
        mine = findings.apply_suppressions([findings.Finding(**args)], src,
                                           fixture)
        theirs = ref_findings.apply_suppressions(
            [ref_findings.Finding(**args)], src, fixture)
        assert [f.render() for f in mine] == [f.render() for f in theirs]


def test_a_suppression_needs_its_reason():
    src = ("x = 1  # repro: allow[global-rng] -- the test's own draw\n"
           "# repro: allow[host-sync-in-step]\n"
           "y = 2\n")
    allow, bare = findings.scan_suppressions(src)
    assert allow == {1: {"global-rng": "the test's own draw"}}
    assert [line for line, _ in bare] == [2]
    out = findings.apply_suppressions(
        [findings.Finding(rule="global-rng", path="f", line=1, message="m"),
         findings.Finding(rule="host-sync-in-step", path="f", line=3,
                          message="m")], src, "f")
    assert [(f.rule, f.suppressed) for f in out] == [
        ("global-rng", True), ("host-sync-in-step", False),
        (findings.BARE_SUPPRESSION, False)]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def test_cli_lists_the_rules_and_the_entry_points():
    res = _cli("--list-rules")
    assert res.returncode == 0, res.stderr
    assert [ln.split()[0] for ln in res.stdout.splitlines()] == [
        "host-sync-in-step", "tensor-branch-in-step", "global-rng",
        "implicit-dtype"]
    res = _cli("--list-entry-points")
    assert res.returncode == 0, res.stderr
    names = [ln.split()[0] for ln in res.stdout.splitlines()]
    assert len(names) == 17 and len(set(names)) == 17
    assert {"netes.run", "netes.run.q8", "netes.run_scheduled",
            "obs.netes.run.probed", "kernels.fused_neighbor_sum.plain",
            "netes_dist.consensus_step", "fleet_shard.sharded_step",
            "permute_mixing.rotating_switch"} <= set(names)


def test_cli_exits_1_on_a_bad_fixture_and_0_on_a_clean_one():
    res = _cli(str(FIXTURES / "bad_global_rng.py"))
    assert res.returncode == 1 and "1 finding(s)" in res.stdout
    res = _cli(str(FIXTURES / "clean_global_rng.py"))
    assert res.returncode == 0 and "0 finding(s)" in res.stdout
