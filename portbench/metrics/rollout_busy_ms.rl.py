"""Device milliseconds an iteration of the kernels launched in the
program's ``netes.rollout`` range (the 2N episodes), the union of their
intervals, from the traced chunk's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "netes.rollout")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
