"""PyTorch / CUDA port of brainfm_tpu for NVIDIA Hopper (H100).

Mirrors brainfm_tpu's module layout; the JAX package is the reference the
tests hold this one to. Entry points run on the GPU unless the caller asks
for the CPU (`device="cpu"`), where every kernel wrapper takes its plain
PyTorch twin. Importing this package builds nothing and touches no GPU,
and it imports no torch: `python -m brainfm_tpu_torch.bench` moves its
standard output aside before torch is loaded.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
