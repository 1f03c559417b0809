"""Architecture registry of the port. ``--arch <id>`` resolves through
``get_config``; the reference's other architectures raise
``NotImplementedError`` naming the slice that brings them."""
from .base import (LayerSpec, ModelConfig, available_archs, get_config,
                   register)

__all__ = ["LayerSpec", "ModelConfig", "available_archs", "get_config",
           "register"]
