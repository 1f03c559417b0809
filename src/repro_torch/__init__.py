"""PyTorch/CUDA port of the NetES reproduction (``repro``, the JAX reference).

The package mirrors ``src/repro/`` module for module. It imports torch and
numpy only; the JAX package is its reference in the tests alone. Entry
points take an explicit ``device`` that defaults to ``cuda`` and raise when
no GPU is present, unless the caller asks for ``device="cpu"``.
"""
import torch

# Strict float32 throughout: the JAX reference computes in full f32, and
# TF32 keeps about three decimal digits. Matmuls already default to full
# f32; cuDNN convolutions do not, so both switches are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
