"""Share of its roofline that Eq. 3 reaches: the least time the mixing of
these shapes needs on the card (the dense count 2·N²·D or the sparse count
2·E·D over the graph's real edges, whichever is less; operands read once,
θ' written once; ``roofline.py``) over the Eq. 3 kernels' device time an
iteration (``eq3_ms.rl``)."""
from portbench import harness


def read(ctx):
    ms = harness.load_module("metrics", "eq3_ms.rl").read(ctx)
    if not ms:
        return None
    return 100.0 * ctx["counts"]["eq3_least_s"] * 1e3 / ms
