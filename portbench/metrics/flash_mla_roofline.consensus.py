"""The latent-attention flash instance's share of its roofline: the
causal cores' flops a step (2·H·(192 + 128)·S(S+1)/2 a call,
``roofline_moonlight.flash_mla``) at the card's float32 peak, over the
device time of the kernels named ``flash_attention_kernel<192, 128>`` in
the traced step."""
import re

from portbench import roofline

NAME = re.compile(r"flash_attention_kernel<192,\s*128>")


def read(ctx):
    flops = ctx["counts"].get("flash_mla_flops")
    prof = ctx["profile"]
    t = sum(s for n, s in prof["by_name"].items() if NAME.search(n))
    if not flops or t <= 0:
        return None
    return 100.0 * flops / roofline.PEAK_F32_FLOPS / (t / prof["iters"])
