"""Device milliseconds a step in cuBLAS's matrix products, from the traced
step's profile."""

WORDS = ("gemm", "gemv", "xmma", "cutlass")


def read(ctx):
    prof = ctx["profile"]
    s = sum(t for n, t in prof["by_name"].items()
            if any(w in n.lower() for w in WORDS))
    return s * 1e3 / prof["iters"] if s > 0 else None
