"""Device kernels and copies an iteration launched in the program's
``netes.rollout`` range, from the traced chunk's profile
(``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "netes.rollout")
    if not row:
        return None
    return row["kernels"] / ctx["profile"]["iters"]
