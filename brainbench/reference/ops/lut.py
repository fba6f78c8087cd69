"""Small-table lookups `table[idx]` in plain PyTorch, on any device: a
frozen copy of the port's `lut_apply_plain` (brainfm_tpu_torch/ops/lut.py),
the version the port's hand-written lookup kernel is held to."""

from __future__ import annotations

import torch


def lut_apply(table, idx):
    """table[idx] for a (K,) or (K, C) table and integer idx of any shape;
    indices outside [0, K) give 0 (PyTorch indexing would wrap -1)."""
    squeeze = table.dim() == 1
    tbl = table[:, None] if squeeze else table
    K = tbl.shape[0]
    valid = (idx >= 0) & (idx < K)
    out = tbl[idx.long().clamp(0, K - 1)]
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=tbl.dtype,
                                                         device=tbl.device))
    return out[..., 0] if squeeze else out
