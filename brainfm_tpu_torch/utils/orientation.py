"""RAS orientation utilities (host-side numpy; a copy of
brainfm_tpu/utils/orientation.py, with the axis bookkeeping split from the
voxel copy so a caller can reorder a volume where it lies).

Parity with the reference's utils/misc.py:226-238 (`get_ras_axes`) and
:1207-1247 (`align_volume_to_ref`). These run on host metadata, not on
device — unchanged semantics from the reference.
"""

from __future__ import annotations

import numpy as np


def get_ras_axes(aff: np.ndarray, n_dims: int = 3) -> np.ndarray:
    """Voxel axis carrying each RAS direction (parity: misc.py:226-238,
    including the ties fix that reassigns duplicate axes)."""
    aff_inv = np.linalg.inv(aff)
    img_ras_axes = np.argmax(np.absolute(aff_inv[0:n_dims, 0:n_dims]), axis=0)
    for i in range(n_dims):
        if i not in img_ras_axes:
            unique, counts = np.unique(img_ras_axes, return_counts=True)
            incorrect = unique[np.argmax(counts)]
            img_ras_axes[np.where(img_ras_axes == incorrect)[0][-1]] = i
    return img_ras_axes


def ras_reorientation(aff: np.ndarray, shape, aff_ref: np.ndarray | None = None,
                      n_dims: int = 3):
    """The voxel reordering of `align_volume_to_ref` for a volume of
    `shape` with affine `aff`, without touching voxels: (perm, flips,
    new_aff), the aligned volume being the input with its first n_dims axes
    transposed by `perm` and then flipped along the axes in `flips`."""
    aff_flo = np.asarray(aff, float).copy()
    if aff_ref is None:
        aff_ref = np.eye(4)
    ras_axes_ref = get_ras_axes(aff_ref, n_dims)
    ras_axes_flo = get_ras_axes(aff_flo, n_dims)

    aff_flo[:, ras_axes_ref] = aff_flo[:, ras_axes_flo]
    perm = list(range(n_dims))
    for i in range(n_dims):
        if ras_axes_flo[i] != ras_axes_ref[i]:
            a, b = ras_axes_flo[i], ras_axes_ref[i]
            perm[a], perm[b] = perm[b], perm[a]      # np.swapaxes(vol, a, b)
            swapped = np.where(ras_axes_flo == ras_axes_ref[i])
            ras_axes_flo[swapped], ras_axes_flo[i] = ras_axes_flo[i], ras_axes_flo[swapped]
    shape = [shape[p] for p in perm]

    dots = np.sum(aff_flo[:3, :3] * aff_ref[:3, :3], axis=0)
    flips = []
    for i in range(n_dims):
        if dots[i] < 0:
            flips.append(i)
            aff_flo[:, i] = -aff_flo[:, i]
            aff_flo[:3, 3] = aff_flo[:3, 3] - aff_flo[:3, i] * (shape[i] - 1)
    return perm, flips, aff_flo


def align_volume_to_ref(volume: np.ndarray, aff: np.ndarray,
                        aff_ref: np.ndarray | None = None,
                        return_aff: bool = False, n_dims: int = 3):
    """Swap/flip voxel axes so the volume matches a reference orientation
    (parity: misc.py:1207-1247)."""
    perm, flips, aff_flo = ras_reorientation(aff, volume.shape, aff_ref,
                                             n_dims)
    volume = np.transpose(volume, perm + list(range(n_dims, volume.ndim)))
    if flips:
        volume = np.flip(volume, axis=tuple(flips))
    if return_aff:
        return np.ascontiguousarray(volume), aff_flo
    return np.ascontiguousarray(volume)
