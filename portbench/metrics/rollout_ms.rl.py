"""Device milliseconds an iteration in the rollout (the 2N episodes: the
environment and the policy), from CUDA events the benchmark records around
the reward function's call in the traced run's window."""


def read(ctx):
    spans = ctx["window"]["spans"].get("rollout_ms")
    return sum(spans) / len(spans) if spans else None
