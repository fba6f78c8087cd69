"""Inference preprocessing (port of brainfm_tpu/infer/prepare.py).

Parity with the reference's utils/test_utils.py:60-189 (zero_crop,
center_crop) and :235-284 (prepare_image): load, nan cleanup, CT clamp,
min-max rescale, resample to 1 mm, RAS alignment, crop. The file is read
and rescaled on the host with numpy, as in the JAX package; the volume then
moves to the requested device once, and resampling (the acquisition-spacing
warp through K1, ops/warp.py::warp_volume), the RAS axis swaps and flips
(`utils.orientation.ras_reorientation`, the bookkeeping of
`align_volume_to_ref`) and the crops run there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.resize import myzoom, volume_resize
from ..ops.warp import warp_volume
from ..utils.nifti import load_nifti
from ..utils.orientation import ras_reorientation
from ..utils.profiling import annotate, count


def zero_crop_bounds(vol: np.ndarray, tol: float = 0.0):
    """Bounding box of non-background voxels (parity: test_utils.py:60-90)."""
    coords = np.argwhere(vol > tol)
    return coords.min(0), coords.max(0) + 1


def center_crop(vol, win_size, aff: np.ndarray | None = None):
    """(parity: test_utils.py:141-189). vol: numpy array or tensor, cropped
    as a view. Returns (cropped, crop_start, orig_shape, aff)."""
    orig_shp = tuple(vol.shape[:3])
    if aff is None:
        aff = np.eye(4)
    if win_size is None:
        return vol, [0, 0, 0], orig_shp, aff
    if any(orig_shp[i] > win_size[i] for i in range(3)):
        start = [max(orig_shp[i] - win_size[i], 0) // 2 for i in range(3)]
        aff = aff.copy()
        aff[:-1, -1] = aff[:-1, -1] + aff[:-1, :-1] @ np.asarray(start)
        out = vol[start[0]:start[0] + win_size[0],
                  start[1]:start[1] + win_size[1],
                  start[2]:start[2] + win_size[2]]
        return out, start, orig_shp, aff
    return vol, [0, 0, 0], orig_shp, aff


def add_bias_field(im, seed: int = 0, bf_scale_min: float = 0.02,
                   bf_scale_max: float = 0.04, bf_std_min: float = 0.1,
                   bf_std_max: float = 0.6):
    """Synthetic multiplicative bias field for robustness testing (parity:
    add_bias_field, test_utils.py:192-200): a tiny gaussian log-field zoomed
    to full size and exponentiated. The draws are numpy's
    `default_rng(seed)`, the JAX package's, so both make the same field.
    Returns (im * bf, bf) on im's device."""
    rng = np.random.default_rng(seed)
    shp = np.asarray(im.shape[:3])
    scale = bf_scale_min + rng.random() * (bf_scale_max - bf_scale_min)
    small = np.round(scale * shp).astype(int)
    std = bf_std_min + (bf_std_max - bf_std_min) * rng.random()
    count("host_syncs")
    bf_log = torch.from_numpy(
        (std * rng.standard_normal(small)).astype(np.float32)).to(im.device)
    bf = torch.exp(myzoom(bf_log, shp / small,
                          newsize=tuple(int(v) for v in shp)))
    return im * bf, bf


def acquisition_grid(shape, new_res, device):
    """The source coordinates of the resample of a `shape` volume at 1 mm
    to `new_res` mm (center-aligned `delta=(1-f)/(2f)`): three fp32
    volumes of the low-resolution shape on `device`, and the factors."""
    shp = np.asarray(shape[:3])
    new_size = (shp / np.asarray(new_res, np.float64)).astype(int)
    factors = new_size / shp
    delta = (1.0 - factors) / (2.0 * factors)
    vs = [np.arange(delta[a], delta[a] + new_size[a] / factors[a],
                    1 / factors[a])[: new_size[a]] for a in range(3)]
    count("host_syncs", 3)
    grid = [torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(device)
            for c in np.meshgrid(*vs, sparse=False, indexing="ij")]
    return grid, factors


def resample_roundtrip(im, new_res):
    """Acquisition simulation: resample to `new_res` mm and zoom back to the
    1 mm grid (parity: resample, test_utils.py:202-232: center-aligned
    `delta=(1-f)/(2f)` coordinates both ways). The down-sampling warp is K1
    (`warp_volume`, C=1, default 0) on CUDA."""
    grid, factors = acquisition_grid(im.shape, new_res, im.device)
    low = warp_volume(im.float().contiguous(), grid, default=0.0)
    return myzoom(low, 1.0 / factors,
                  newsize=tuple(int(v) for v in im.shape[:3]))


def prepare_image(img_path: str, win_size=None, zero_crop_first: bool = False,
                  is_CT: bool = False, is_label: bool = False,
                  rescale: bool = True, spacing=None, add_bf: bool = False,
                  bf_seed: int = 0, device=None):
    """(parity: prepare_image, test_utils.py:235-284 incl. the synthetic
    bias field and acquisition-spacing resample). Returns
    (im: tensor (D,H,W) on `device` (default CUDA), aff, crop_start,
    orig_shp). Spans `serve.read` (the file) and `serve.prepare` (the
    rest), utils/profiling.py."""
    dev = resolve_device(device)
    with annotate("serve.read"):
        im, aff = load_nifti(img_path)
    with annotate("serve.prepare"):
        im = np.nan_to_num(np.squeeze(im)).astype(np.int32 if is_label
                                                  else np.float32)
        if im.ndim > 3:
            im = im.mean(-1)
        if is_CT and rescale:
            im = np.clip(im, 0.0, 80.0)
        if not is_label and rescale:
            im = im - im.min()
            mx = im.max()
            if mx > 0:
                im = im / mx

        # NIfTI voxels come in Fortran order: copied to the device as they
        # lie, they are made C-contiguous there, where the transposed copy
        # is cheap
        count("host_syncs")
        t, aff = volume_resize(torch.from_numpy(im).to(dev).contiguous(), aff,
                               1.0)
        if add_bf and not is_CT and not is_label:
            t, _ = add_bias_field(t, seed=bf_seed)
        if spacing is not None and not is_label:
            t = resample_roundtrip(t, spacing)
        perm, flips, aff = ras_reorientation(aff, t.shape, aff_ref=np.eye(4))
        t = t.permute(perm)
        if flips:
            t = t.flip(flips)
        if zero_crop_first:
            count("host_syncs")
            lo, hi = zero_crop_bounds(t.cpu().numpy())
            t = t[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        t, crop_start, orig_shp, aff = center_crop(t, win_size, aff)
        return t.contiguous(), aff, crop_start, orig_shp
