"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: the port is
``repro_torch``), and the reference nothing of the port. Each check runs
in a fresh interpreter, since a test worker may hold JAX from other
tests."""
import json
import os
import subprocess
import sys

from portbench import harness

REFERENCE = """
import json, sys
import portbench.reference.netes_ref, portbench.reference.jamba_ref
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""

RUN = """
import json, sys
from portbench import harness
from portbench.test_portbench_cells import tiny_lm, tiny_rl
from portbench.runners import consensus_lm, netes_rl
for runner, (config, traffic, _) in (
        (netes_rl, tiny_rl("pendulum.er.n16384")),
        (consensus_lm, tiny_lm())):
    run = runner.Run(config, traffic, 7, "cpu")
    run.window(0.0, spans=False)
    runner.compare(run.release(), config, traffic, 7, "cpu")
print(json.dumps(harness.forbidden_loaded()))
"""


def _python(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(harness.REPO), str(harness.REPO / "src")])
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    tops = set(_python(REFERENCE))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_no_jax_and_not_the_jax_package():
    assert _python(RUN) == []


def test_sources_name_no_other_harness():
    for path in harness.ROOT.rglob("*.py"):
        if path.name == "test_portbench_imports.py":
            continue
        text = path.read_text()
        for word in ("import chip_smoke", "from chip_smoke",
                     "import benchmarks", "from benchmarks",
                     "import jax", "from jax", "import repro\n",
                     "from repro."):
            assert word not in text, (path, word)
