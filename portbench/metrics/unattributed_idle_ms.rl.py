"""Milliseconds an iteration in which the device idled while the host was
in no program range: with ``netes.step`` around each iteration, the idle
between the chunk's iterations (``phases.py``). Nothing where the profile
has no ``netes.step``."""
from portbench import phases


def read(ctx):
    if not phases.phase(ctx, "netes.step"):
        return None
    found = ctx["profile"]["phases"]
    return found["unattributed_idle_s"] * 1e3 / ctx["profile"]["iters"]
