"""PNG montages of training progress (port of
brainfm_tpu/utils/visualizer.py): mid-slice grids of inputs, targets and
outputs, and feature-channel strips, written every `vis_itr`. The same
numpy code and PNG encoder (zlib, no PIL) as the JAX package, so equal
arrays give equal PNG bytes; tensors come to the host once per call.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def _png_write(path: str, img: np.ndarray):
    """Write a (H, W) or (H, W, 3) uint8 array as PNG."""
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _to_u8(x):
    x = np.nan_to_num(np.asarray(x, np.float32))
    lo, hi = x.min(), x.max()
    if hi - lo < 1e-12:
        return np.zeros_like(x, np.uint8)
    return ((x - lo) / (hi - lo) * 255).astype(np.uint8)


def _mid_slices(vol):
    """Three orthogonal mid-slices of a (D,H,W) volume, padded to a row."""
    d, h, w = vol.shape
    sl = [vol[d // 2], vol[:, h // 2], vol[:, :, w // 2]]
    hh = max(s.shape[0] for s in sl)
    ww = max(s.shape[1] for s in sl)
    row = np.zeros((hh, ww * 3), np.float32)
    for i, s in enumerate(sl):
        row[: s.shape[0], i * ww: i * ww + s.shape[1]] = s
    return row


def to_host(x):
    """A tensor or array as a float32 numpy array: one device -> host copy
    for a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class TaskVisualizer:
    """(parity: TaskVisualizer, Trainer/visualizer.py:212-333): one PNG per
    call, rows of three mid-slices: the input, then target and output of
    each key both hold."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def visualize(self, step: int, samples: dict, targets: dict,
                  outputs: dict, names=None):
        rows = []
        def vol_of(x):
            # sliced where it lies, so only the volume moves to the host
            a = x
            while a.ndim > 3:
                a = a[0] if a.shape[0] <= a.shape[-1] else a[..., 0]
            return to_host(a)

        if "input" in samples:
            rows.append(_mid_slices(vol_of(samples["input"])))
        for name in (names or sorted(set(targets) & set(outputs))):
            t, o = targets.get(name), outputs.get(name)
            if t is None or o is None or not hasattr(t, "shape"):
                continue
            if getattr(t, "ndim", 0) < 3:
                continue
            rows.append(_mid_slices(vol_of(t)))
            rows.append(_mid_slices(vol_of(o)))
        if not rows:
            return None
        ww = max(r.shape[1] for r in rows)
        canvas = np.zeros((sum(r.shape[0] for r in rows), ww), np.float32)
        y = 0
        for r in rows:
            canvas[y: y + r.shape[0], : r.shape[1]] = _to_u8(r)
            y += r.shape[0]
        path = os.path.join(self.out_dir, f"vis_{step:07d}.png")
        _png_write(path, canvas.astype(np.uint8))
        return path


class FeatVisualizer:
    """Feature-channel strips (parity: FeatVisualizer,
    visualizer.py:106-209): the mid axial slice of the first `n_channels`
    channels of a channels-last (..., D, H, W, C) feature map (the joiners
    return their features channels last)."""

    def __init__(self, out_dir: str, n_channels: int = 10):
        self.out_dir = out_dir
        self.n = n_channels
        os.makedirs(out_dir, exist_ok=True)

    def visualize(self, step: int, feat):
        f = feat
        while f.ndim > 4:
            f = f[0]
        # (D,H,W,C): the mid axial slice of each channel, one host copy
        f = to_host(f[f.shape[0] // 2, :, :, :self.n])
        chans = [f[:, :, c] for c in range(f.shape[-1])]
        strip = np.concatenate([_to_u8(c) for c in chans], axis=1)
        path = os.path.join(self.out_dir, f"feat_{step:07d}.png")
        _png_write(path, strip)
        return path
