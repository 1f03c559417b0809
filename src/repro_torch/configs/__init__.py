"""Architecture registry of the port. ``--arch <id>`` resolves through
``get_config``; the reference's NetES policy ``paper-mlp`` raises
``NotImplementedError`` naming where the port has it.

``ASSIGNED_ARCHS``, ``INPUT_SHAPES``, ``LONG_CONTEXT_ARCHS`` and
``shape_pairs`` are the reference's (``repro.configs``): the archs and
input shapes that ``launch.specs`` classifies into placement modes."""
from .base import (LayerSpec, ModelConfig, available_archs, get_config,
                   register)

ASSIGNED_ARCHS = (
    "jamba-v0.1-52b",
    "rwkv6-7b",
    "whisper-tiny",
    "moonshot-v1-16b-a3b",
    "llama4-scout-17b-a16e",
    "mistral-nemo-12b",
    "gemma3-4b",
    "llama4-maverick-400b-a17b",
    "phi3-medium-14b",
    "llava-next-mistral-7b",
)

INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k eligibility (DESIGN.md §5): sub-quadratic archs only.
LONG_CONTEXT_ARCHS = (
    "jamba-v0.1-52b",            # mamba + sliding-window attention
    "rwkv6-7b",                  # O(1) state
    "gemma3-4b",                 # 5:1 local:global
    "llama4-scout-17b-a16e",     # chunked attention
    "llama4-maverick-400b-a17b", # chunked attention
)


def shape_pairs():
    """All (arch, shape) pairs, long_500k for the long-context archs
    only."""
    pairs = []
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            pairs.append((arch, shape))
    return pairs


__all__ = ["LayerSpec", "ModelConfig", "available_archs", "get_config",
           "register", "ASSIGNED_ARCHS", "INPUT_SHAPES",
           "LONG_CONTEXT_ARCHS", "shape_pairs"]
