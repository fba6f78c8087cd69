"""PyTorch / CUDA port of brainfm_tpu for NVIDIA Hopper (H100).

Mirrors brainfm_tpu's module layout; the JAX package is the reference the
tests hold this one to. Entry points run on the GPU unless the caller asks
for the CPU (`device="cpu"`), where every kernel wrapper takes its plain
PyTorch twin. Importing this package builds nothing and touches no GPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
