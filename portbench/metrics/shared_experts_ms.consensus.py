"""Device milliseconds a step of the kernels launched in the program's
``moe.shared`` ranges (the shared experts, one SwiGLU on every token of
every MoE layer of every member loss), the union of their intervals, from
the traced step's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "moe.shared")
    if not row:
        return None
    return row["busy_s"] * 1e3 / ctx["profile"]["iters"]
