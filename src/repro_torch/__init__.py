"""PyTorch/CUDA port of the ``repro`` execution layer for one NVIDIA H100.

Mirrors ``repro``'s subpackage and function names so each counterpart is
easy to find. It carries co-scheduled, gradient-accumulated training of
every family of the reference (dense, vlm, hybrid, moe, ssm and audio)
through the schedule executor, with
its fault recovery (scripted faults, retry, member drop, npz checkpoints
in the reference's format, restart) and the training driver
(``launch.train``, ``launch.quickstart``); the calibration of (alpha,
beta, xi) and the replay of a simulated SJF-BSBF schedule; and serving
(prefill, decode, ``generate``, the continuous-batching
``DecodeEngine``). Attention, decode and the Mamba2 SSD scan run on
hand-written CUDA kernels (``kernels/csrc/``) when their tensors are on
the card.

The package imports neither ``jax`` nor anything from ``repro``; it keeps
its own copy of whatever it needs. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no explicit CPU device they
raise instead of falling back.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
