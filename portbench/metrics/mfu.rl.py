"""The whole iteration's share of the card's float32 peak: the policy's
products over the 2N·200 episode steps plus Eq. 3's least flop count
(``roofline.py``), over the window's ``rl_iter_ms``."""
from portbench import roofline


def read(ctx):
    c = ctx["counts"]
    ms = ctx["window"]["metrics"]["rl_iter_ms"]
    return (100.0 * (c["rollout_flops"] + c["eq3_flops"])
            / (ms * 1e-3) / roofline.PEAK_F32_FLOPS)
