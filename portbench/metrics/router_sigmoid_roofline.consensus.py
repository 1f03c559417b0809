"""The sigmoid router instance's share of its roofline: its bytes a step
(the logits and the bias read, the gates and the ids written, once a MoE
layer of every member loss, ``roofline_moonlight.router_sigmoid``) at the
card's memory bandwidth, over the device time of the kernels named
``moe_topk_sigmoid_kernel`` in the traced step."""
from portbench import roofline


def read(ctx):
    nbytes = ctx["counts"].get("router_sigmoid_bytes")
    prof = ctx["profile"]
    t = sum(s for n, s in prof["by_name"].items()
            if "moe_topk_sigmoid_kernel" in n)
    if not nbytes or t <= 0:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (t / prof["iters"])
