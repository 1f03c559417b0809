"""Milliseconds a step in which the device idled while the host was in the
program's ``consensus.members`` range (the 2P member losses), its own and
its ``consensus.perturb`` and ``consensus.forward`` ranges' together, by
the idle gaps' midpoints, from the traced step's profile
(``phases.py``)."""
from portbench import phases

RANGES = ("consensus.members", "consensus.perturb", "consensus.forward")


def read(ctx):
    if not phases.phase(ctx, "consensus.members"):
        return None
    rows = [phases.phase(ctx, name) or {"idle_s": 0.0} for name in RANGES]
    return sum(r["idle_s"] for r in rows) * 1e3 / ctx["profile"]["iters"]
