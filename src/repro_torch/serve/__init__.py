"""Serving of the port (``repro/serve``)."""
from .engine import ServeEngine

__all__ = ["ServeEngine"]
