"""Share of the traced chunk in which no operation ran on the device."""


def read(ctx):
    prof = ctx["profile"]
    if prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
