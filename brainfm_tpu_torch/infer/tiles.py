"""Tiled whole-volume inference (port of brainfm_tpu/infer/tiles.py).

Parity with the reference's sliding-window path (utils/test_utils.py:93-137
`tiling` + the count-normalized blend of scripts/demo_test.py:106-119). The
JAX package has two walks, a jitted `lax.scan` (`make_tiled_fused`) and a
per-tile dispatch loop, because each dispatch there costs a round trip.
Kernels queued on a CUDA stream cost no such round trip, so one loop over
the tile offsets serves both: it follows the scan's semantics (windows
clamped to the volume, never padded; canvases in `accum_dtype`).
"""

from __future__ import annotations

import numpy as np
import torch


def tile_plan(shape, stride=(40, 40, 40), win_size=(160, 160, 160)):
    """Tile index ranges + overlap counts (parity: test_utils.py:93-137 —
    same greedy walk, end-clamped windows)."""
    axes = []
    for d in range(3):
        win = min(win_size[d], shape[d])
        starts = list(range(0, max(shape[d] - win, 0) + 1, stride[d]))
        if starts[-1] != shape[d] - win:  # clamp final window to the end
            starts.append(shape[d] - win)
        axes.append([(s, s + win) for s in starts])
    tiles = []
    cnt = np.zeros(shape, np.float32)
    for xs, xe in axes[0]:
        for ys, ye in axes[1]:
            for zs, ze in axes[2]:
                tiles.append(((xs, xe), (ys, ye), (zs, ze)))
                cnt[xs:xe, ys:ye, zs:ze] += 1
    return tiles, cnt


def tiled_apply(apply_fn, params, vol, stride=(80, 80, 80),
                win_size=(160, 160, 160), accum_dtype=torch.float32):
    """Run `apply_fn(params, tile (1,d,h,w,1)) -> {name: (1,d,h,w,C)}` over
    the tile grid of `vol` (D,H,W) and blend by overlap-count averaging.
    Canvases live on vol's device in `accum_dtype` (fp32 default: the
    reference's blend); each output is cast back to its own dtype before
    the division by the count, as the JAX scan does. `params` is passed
    through to `apply_fn` as it is (it may be None)."""
    shape = tuple(vol.shape)
    tiles, cnt = tile_plan(shape, stride, win_size)
    canvases, dtypes = {}, {}
    for (xs, xe), (ys, ye), (zs, ze) in tiles:
        out = apply_fn(params, vol[xs:xe, ys:ye, zs:ze][None, ..., None])
        for name, val in out.items():
            if name not in canvases:
                canvases[name] = torch.zeros(shape + (val.shape[-1],),
                                             dtype=accum_dtype,
                                             device=vol.device)
                dtypes[name] = val.dtype
            canvases[name][xs:xe, ys:ye, zs:ze] += val[0].to(accum_dtype)
    cntj = torch.from_numpy(cnt).to(vol.device)[..., None]
    return {n: c.to(dtypes[n]) / cntj for n, c in canvases.items()}
