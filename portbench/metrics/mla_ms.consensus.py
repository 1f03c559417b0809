"""Device milliseconds a step of the kernels launched in the program's
``mla`` ranges (the latent-attention mixer, from its projections to its
output projection, in every member loss), the union of their intervals,
from the traced step's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "mla")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
