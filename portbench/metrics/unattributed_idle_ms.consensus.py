"""Milliseconds a step in which the device idled while the host was in no
program range: with ``consensus.step`` around the step, the idle before
and after it in the traced window (``phases.py``). Nothing where the
profile has no ``consensus.step``."""
from portbench import phases


def read(ctx):
    if not phases.phase(ctx, "consensus.step"):
        return None
    found = ctx["profile"]["phases"]
    return found["unattributed_idle_s"] * 1e3 / ctx["profile"]["iters"]
