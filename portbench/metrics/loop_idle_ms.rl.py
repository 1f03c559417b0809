"""Milliseconds an iteration in which the device idled outside the
rollout: the traced chunk's idle time (the window less its busy time) an
iteration, less ``rollout_idle_ms.rl`` (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "netes.rollout")
    if not row:
        return None
    prof = ctx["profile"]
    idle = prof["window_s"] - prof["busy_s"] - row["idle_s"]
    return idle * 1e3 / prof["iters"]
