"""Milliseconds an iteration in which the device idled while the host was
in the program's ``netes.rollout`` range (the idle gaps whose midpoint
falls there), from the traced chunk's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "netes.rollout")
    if not row:
        return None
    return row["idle_s"] * 1e3 / ctx["profile"]["iters"]
