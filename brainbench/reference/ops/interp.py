"""Plain PyTorch 3-D resampling at arbitrary coordinates (port of
brainfm_tpu/ops/interp.py).

These are the plain versions of K1 (csrc/warp.cu): ops/warp.py takes them
for CPU tensors, and the tests and chip_smoke.py hold the kernel to them.
"""

from __future__ import annotations

import torch


def _flat_gather(vol_flat, d, h, w, H, W):
    idx = (d * H + h) * W + w
    return vol_flat.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, vol_flat.shape[-1])


def trilinear3d(vol, ii, jj, kk, default=0.0):
    """Trilinear sample of `vol` (D,H,W) or (D,H,W,C) at float coords.

    Out of bounds (ii < tiny or ii > D-1, likewise jj, kk) gives `default`:
    a scalar, or a (C,) vector of per-channel defaults. `tiny` is the
    smallest normal float of the coordinates' type (FLT_MIN for float32):
    the reference tests `ii > 0` under XLA, which flushes denormals to zero,
    so a denormal coordinate is out of bounds there; `ii >= tiny` is that
    same test without the flush. Returns coords.shape (+ (C,) if vol has
    channels)."""
    squeeze = vol.dim() == 3
    if squeeze:
        vol = vol[..., None]
    D, H, W, C = vol.shape
    vol_flat = vol.reshape(D * H * W, C)

    tiny = torch.finfo(ii.dtype).tiny
    ok = ((ii >= tiny) & (jj >= tiny) & (kk >= tiny) & (ii <= D - 1)
          & (jj <= H - 1) & (kk <= W - 1))

    iic = ii.clamp(0.0, D - 1)
    jjc = jj.clamp(0.0, H - 1)
    kkc = kk.clamp(0.0, W - 1)

    fx = torch.floor(iic).long()
    fy = torch.floor(jjc).long()
    fz = torch.floor(kkc).long()
    cx = (fx + 1).clamp(max=D - 1)
    cy = (fy + 1).clamp(max=H - 1)
    cz = (fz + 1).clamp(max=W - 1)

    wcx = (iic - fx)[..., None]
    wcy = (jjc - fy)[..., None]
    wcz = (kkc - fz)[..., None]
    wfx, wfy, wfz = 1.0 - wcx, 1.0 - wcy, 1.0 - wcz

    c000 = _flat_gather(vol_flat, fx, fy, fz, H, W)
    c100 = _flat_gather(vol_flat, cx, fy, fz, H, W)
    c010 = _flat_gather(vol_flat, fx, cy, fz, H, W)
    c110 = _flat_gather(vol_flat, cx, cy, fz, H, W)
    c001 = _flat_gather(vol_flat, fx, fy, cz, H, W)
    c101 = _flat_gather(vol_flat, cx, fy, cz, H, W)
    c011 = _flat_gather(vol_flat, fx, cy, cz, H, W)
    c111 = _flat_gather(vol_flat, cx, cy, cz, H, W)

    c00 = c000 * wfx + c100 * wcx
    c01 = c001 * wfx + c101 * wcx
    c10 = c010 * wfx + c110 * wcx
    c11 = c011 * wfx + c111 * wcx
    c0 = c00 * wfy + c10 * wcy
    c1 = c01 * wfy + c11 * wcy
    out = c0 * wfz + c1 * wcz

    default = torch.as_tensor(default, dtype=out.dtype, device=out.device)
    out = torch.where(ok[..., None], out, default)
    if squeeze:
        out = out[..., 0]
    return out


def nearest3d(vol, ii, jj, kk):
    """Nearest-neighbour sample: round half to even, then clip. A denormal
    coordinate rounds to 0 with or without a flush to zero, so this needs
    no lower-bound care (see trilinear3d)."""
    squeeze = vol.dim() == 3
    if squeeze:
        vol = vol[..., None]
    D, H, W, C = vol.shape
    vol_flat = vol.reshape(D * H * W, C)
    ir = torch.round(ii).long().clamp(0, D - 1)
    jr = torch.round(jj).long().clamp(0, H - 1)
    kr = torch.round(kk).long().clamp(0, W - 1)
    out = _flat_gather(vol_flat, ir, jr, kr, H, W)
    if squeeze:
        out = out[..., 0]
    return out


def interp3d(vol, ii, jj, kk, mode: str = "linear", default=0.0):
    """trilinear3d (mode 'linear', out-of-bounds voxels `default`) or
    nearest3d (mode 'nearest'), as fast_3D_interp_torch's `mode`."""
    if mode == "linear":
        return trilinear3d(vol, ii, jj, kk, default)
    if mode == "nearest":
        return nearest3d(vol, ii, jj, kk)
    raise ValueError("mode must be linear or nearest")
