"""The synthetic token pipeline, the port of ``repro.data``."""
from .synthetic import batch_seed, make_batch, synthetic_batch_iterator

__all__ = ["batch_seed", "make_batch", "synthetic_batch_iterator"]
