"""Device kernels an iteration, counted in the traced chunk's profile."""


def read(ctx):
    prof = ctx["profile"]
    return prof["kernels"] / prof["iters"] if prof["kernels"] else None
