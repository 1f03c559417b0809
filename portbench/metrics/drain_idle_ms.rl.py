"""Milliseconds an iteration in which the device idled while the host was
in the program's ``obs.device_get`` range (the chunk's one drain of its
metrics to the host: the copy's round trip and the host's wait), by the
idle gaps' midpoints, from the traced chunk's profile (``phases.py``)."""
from portbench import phases


def read(ctx):
    row = phases.phase(ctx, "obs.device_get")
    if not row:
        return None
    return row["idle_s"] * 1e3 / ctx["profile"]["iters"]
