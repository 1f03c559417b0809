"""Checkpoints of the port's training state (flat-key npz)."""
from .io import (load_pytree, path_key, restore_train_state, save_pytree,
                 save_train_state)

__all__ = ["save_pytree", "load_pytree", "save_train_state",
           "restore_train_state", "path_key"]
