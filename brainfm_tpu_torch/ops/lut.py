"""Small-table lookups `table[idx]` (port of brainfm_tpu/ops/pallas_lut.py).

`lut_apply` launches K2 (csrc/lut.cu, `lut_gather_f32` / `lut_gather_i32`)
on CUDA tensors and takes the plain version, `lut_apply_plain`, on CPU
tensors only. The kernel replaces the TPU's compare-accumulate
(pallas_lut.py `_lut_pallas`); its bound on the H100 is bytes: the indices
read once and the rows written once.
"""

from __future__ import annotations

import torch

from .. import kernels

_KERNEL = {torch.float32: "lut_gather_f32", torch.int32: "lut_gather_i32"}


def lut_apply_plain(table, idx):
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


def lut_apply(table, idx):
    """table[idx] with table (K,) or (K, C) and integer idx of any shape;
    out-of-range indices give 0 and an integer table keeps its dtype.
    Returns idx.shape (+ (C,))."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return lut_apply_plain(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"lut_apply: table on {table.device}, idx on "
                         f"{idx.device}; both must be on one CUDA device "
                         "or both on the CPU")
    if table.dtype not in _KERNEL or idx.dtype != torch.int32:
        raise TypeError(f"lut_apply: table {table.dtype} (float32 or int32), "
                        f"idx {idx.dtype} (int32)")
    if table.dim() not in (1, 2) or not (table.is_contiguous()
                                         and idx.is_contiguous()):
        raise ValueError("lut_apply: table must be (K,) or (K, C), and both "
                         "tensors contiguous")
    K = table.shape[0]
    C = 1 if table.dim() == 1 else table.shape[1]
    out = torch.empty((*idx.shape, C), dtype=table.dtype, device=idx.device)
    kernels.launch(_KERNEL[table.dtype], table.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), K, C, idx.numel())
    return out[..., 0] if table.dim() == 1 else out
