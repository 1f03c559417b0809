"""Share of the (token, choice) pairs that the MoE dispatch dropped over
capacity in the traced step, in every MoE layer of every member loss:
the program's ``moe.dropped`` over ``moe.routed`` counters (taken on the
device while the profiler records, read after the step)."""


def read(ctx):
    routed = ctx["counts"].get("moe_routed")
    if not routed:
        return None
    return 100.0 * ctx["counts"]["moe_dropped"] / routed
