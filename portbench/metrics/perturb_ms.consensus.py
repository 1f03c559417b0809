"""Device milliseconds a step of the kernels launched in the program's
``consensus.perturb`` ranges (each member's θ + σε, drawn a slab at a
time, and its mirror 2θ − (θ + σε): 2P a step), the union of their
intervals, from the traced step's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "consensus.perturb")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
