"""PyTorch/CUDA port of the ``repro`` execution layer for one NVIDIA H100.

Mirrors ``repro``'s subpackage and function names so each counterpart is
easy to find. This slice carries the paper's main path: co-scheduled,
gradient-accumulated training of the dense and vlm families, with the
flash-attention forward, dQ and dK/dV as hand-written CUDA kernels
(``kernels/csrc/flash_attention.cu``).

The package imports neither ``jax`` nor anything from ``repro``; it keeps
its own copy of whatever it needs. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no explicit CPU device they
raise instead of falling back.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
