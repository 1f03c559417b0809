"""Transformer models of the port (``repro/models``): dense, MoE, rwkv6 and
hybrid (mamba) decoders."""
