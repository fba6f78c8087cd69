"""Device selection shared by the entry points, and the fp32 scope."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for and absent; there is no silent
    CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions")
    return dev


def card_label(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a
    card set below its full power limit runs slower under load), or the
    device type off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[dev.index or 0]


class _TF32Scope:
    """Process-wide count of the threads inside `exact_fp32`: TF32 is off
    while the count is above 0 and the caller's flags come back when it
    drops to 0, so two threads that enter and leave out of order cannot
    leave the flags changed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.saved = None


_TF32 = _TF32Scope()


@contextlib.contextmanager
def exact_fp32():
    """Run fp32 matrix products (cuBLAS) and convolutions (cuDNN) in full
    fp32 for the duration of the block: TF32 off, as the JAX package's
    `highest` matmul precision. PyTorch reads both flags when an operation
    is issued, so the scope covers exactly the work issued inside it."""
    with _TF32.lock:
        if _TF32.depth == 0:
            _TF32.saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _TF32.depth += 1
    try:
        yield
    finally:
        with _TF32.lock:
            _TF32.depth -= 1
            if _TF32.depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32.saved
