"""Device milliseconds a step of the kernels launched in the program's
``consensus.update`` range (the update's passes over θ, ε regenerated a
slab at a time, and the broadcast), the union of their intervals, from
the traced step's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "consensus.update")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
