"""The whole step's share of the card's float32 peak: the dot flops of the
2P member losses counted from the configuration's shapes (top-k experts a
token; ``roofline.py``), over the window's ``consensus_step_ms``."""
from portbench import roofline


def read(ctx):
    ms = ctx["window"]["metrics"]["consensus_step_ms"]
    return (100.0 * ctx["counts"]["step_flops"] / (ms * 1e-3)
            / roofline.PEAK_F32_FLOPS)
