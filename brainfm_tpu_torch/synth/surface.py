"""Cortical surface targets (port of brainfm_tpu/synth/surface.py).

The four FreeSurfer meshes of a subject's .mat sidecar go through the
inverse affine and the negative SVF of one item's deformation (the
`surface_*` target keys of synth_item), then the sagittal flip's vertex
remap and hemisphere swap. Vertex counts differ per subject, so this runs
per item outside the batch, on numpy with one interpolation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import trilinear3d


def load_surfaces_mat(path: str):
    """{Vlw, Flw, Vrw, Frw, Vlp, Flp, Vrp, Frp} from the .mat sidecar."""
    from scipy.io.matlab import loadmat

    mat = loadmat(path)
    return {k: np.asarray(mat[k]) for k in
            ("Vlw", "Flw", "Vrw", "Frw", "Vlp", "Flp", "Vrp", "Frp")}


def _f32(x):
    return torch.as_tensor(np.asarray(
        x.detach().cpu() if torch.is_tensor(x) else x, np.float32))


def deform_surface_vertices(V, A, c2, Fneg):
    """One vertex set (N, 3) through the inverse affine and the negative
    SVF, in float32 on the CPU."""
    V, A, c2, Fneg = _f32(V), _f32(A), _f32(c2), _f32(Fneg)
    Vc = (V - c2) @ torch.linalg.inv(A).T
    disp = trilinear3d(Fneg, Vc[:, 0] + c2[0], Vc[:, 1] + c2[1],
                       Vc[:, 2] + c2[2])
    return Vc + disp + c2


def deform_surfaces(surfs: dict, A, c2, Fneg, flip: bool, size):
    """All four meshes, with the flip's remap and hemisphere swap."""
    out = {}
    for k in ("Vlw", "Vrw", "Vlp", "Vrp"):
        out[k] = deform_surface_vertices(surfs[k], A, c2, Fneg).numpy()
    for k in ("Flw", "Frw", "Flp", "Frp"):
        out[k] = np.asarray(surfs[k])
    if flip:
        for k in ("Vlw", "Vrw", "Vlp", "Vrp"):
            out[k][:, 0] = size[0] - 1 - out[k][:, 0]
        out["Vlw"], out["Vrw"] = out["Vrw"], out["Vlw"]
        out["Vlp"], out["Vrp"] = out["Vrp"], out["Vlp"]
        out["Flw"], out["Frw"] = out["Frw"], out["Flw"]
        out["Flp"], out["Frp"] = out["Frp"], out["Flp"]
    return out
