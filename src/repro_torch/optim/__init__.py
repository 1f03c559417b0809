"""First-order optimizers on trees of tensors: the port of
``repro/optim``. NetES is the paper's (gradient-free) technique; these give
a conventional first-order path for comparisons and examples."""
from .adam import AdamState, adam_init, adam_update
from .sgd import sgd_update

__all__ = ["AdamState", "adam_init", "adam_update", "sgd_update"]
