"""Architecture registry of the port. ``--arch <id>`` resolves through
``get_config``; the reference's NetES policy ``paper-mlp`` raises
``NotImplementedError`` naming where the port has it."""
from .base import (LayerSpec, ModelConfig, available_archs, get_config,
                   register)

__all__ = ["LayerSpec", "ModelConfig", "available_archs", "get_config",
           "register"]
