"""Device milliseconds a step in the kernels that are neither matrix
products, nor random-number generation, nor the port's own model kernels
(mostly the consensus update's passes over θ, with the forward's
elementwise work), from the traced step's profile."""

NOT = ("gemm", "gemv", "xmma", "cutlass", "normal", "philox",
       "distribution", "mamba_scan_kernel", "moe_topk_kernel",
       "flash_attention_kernel", "memcpy", "memset")


def read(ctx):
    prof = ctx["profile"]
    s = sum(t for n, t in prof["by_name"].items()
            if not any(w in n.lower() for w in NOT))
    return s * 1e3 / prof["iters"] if s > 0 else None
