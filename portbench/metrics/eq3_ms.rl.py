"""Device milliseconds an iteration in the Eq. 3 kernels, from the traced
chunk's profile."""

# The port's Eq. 3 kernels by name (dense, sparse, sparse on the wire).
KERNELS = ("mixing_gemm", "mixing_weights", "mixing_fixup",
           "sparse_mixing_slab", "fused_neighbor_sum_slab")


def read(ctx):
    prof = ctx["profile"]
    s = sum(t for n, t in prof["by_name"].items()
            if any(k in n for k in KERNELS))
    return s * 1e3 / prof["iters"] if s > 0 else None
