"""Transformer models of the port (``repro/models``): dense, MoE and rwkv6
decoders."""
