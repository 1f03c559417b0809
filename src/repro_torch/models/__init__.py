"""Transformer models of the port (``repro/models``): dense decoders."""
