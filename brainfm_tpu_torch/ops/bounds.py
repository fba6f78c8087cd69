"""Boundary-condition index folding for spline sampling (port of
brainfm_tpu/ops/bounds.py).

The DCT/DST/DFT extension conventions of Thevenaz & Unser: each condition
maps an integer node index to (index in [0, n-1], sign). The sign is
{-1, 0, +1}: 0 marks out-of-bounds reads under 'zero' and the node zeros
of dst1; -1 marks antisymmetric reflections (dst1, dst2).
"""

from __future__ import annotations

import torch

BOUND_CODES = {
    "zero": 0, "zeros": 0,
    "replicate": 1, "nearest": 1,
    "dct1": 2, "mirror": 2,
    "dct2": 3, "reflect": 3,
    "dst1": 4, "antimirror": 4,
    "dst2": 5, "antireflect": 5,
    "dft": 6, "wrap": 6,
}


def bound_code(bound) -> int:
    if isinstance(bound, str):
        return BOUND_CODES[bound.lower()]
    return int(bound)


def apply_bound(i, n: int, bound):
    """Fold the integer node index tensor `i` into [0, n-1] under `bound`.
    Returns (index int64, sign float32)."""
    code = bound_code(bound)
    i = i.long()
    one = torch.ones(i.shape, dtype=torch.float32, device=i.device)

    if code == 0:  # zero
        sign = torch.where((i < 0) | (i >= n), 0.0, one)
        return i.clamp(0, n - 1), sign

    if code == 1:  # replicate
        return i.clamp(0, n - 1), one

    if code in (3, 5):  # dct2 / dst2 share the index map (period 2n)
        n2 = 2 * n
        idx = torch.where(i < 0, n2 - 1 - torch.remainder(-i - 1, n2),
                          torch.remainder(i, n2))
        idx = torch.where(idx >= n, n2 - 1 - idx, idx)
        if code == 3:
            return idx, one
        # dst2: odd reflection periods are negated
        j = torch.where(i < 0, n - 1 - i, i)
        sign = torch.where(torch.remainder(j // n, 2) > 0, -1.0, one)
        return idx, sign

    if code == 2:  # dct1 (mirror about the first and last sample)
        if n == 1:
            return torch.zeros_like(i), one
        n2 = 2 * (n - 1)
        idx = torch.remainder(i.abs(), n2)
        idx = torch.where(idx >= n, n2 - idx, idx)
        return idx, one

    if code == 4:  # dst1 (antimirror; zeros at the virtual nodes -1 and n)
        if n == 1:
            # a singleton dimension is the identity with sign +1
            return torch.zeros_like(i), one
        n2 = 2 * (n + 1)
        idx = torch.where(i < 0, -i - 2, i)
        idx = torch.remainder(idx, n2)
        idx = torch.where(idx > n, n2 - 2 - idx, idx)
        idx = torch.where(idx == -1, 0, idx)
        idx = torch.where(idx == n, n - 1, idx)
        j = torch.where(i < 0, -i + (n - 1), i)
        j = torch.remainder(j, n2)
        sign = torch.where(j == 0, 0.0, one)
        sign = torch.where(torch.remainder(j, n + 1) == n, 0.0, sign)
        sign = torch.where(torch.remainder(j // (n + 1), 2) > 0, -sign, sign)
        return idx.clamp(0, n - 1), sign

    if code == 6:  # dft (wrap)
        return torch.remainder(i, n), one

    raise ValueError(f"unknown bound {bound}")
