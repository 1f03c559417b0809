"""Device milliseconds a step of the kernels launched in the program's
``consensus.forward`` ranges (the 2P member losses' forwards), the union
of their intervals, from the traced step's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "consensus.forward")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
