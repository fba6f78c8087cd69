"""What the benchmark makes from `--seed` and hands to the program and to
the plain reference alike: model weights, subjects' label maps and
lesions for training, procedural heads as NIfTI files for serving.

Everything is drawn by `torch.Generator`s on the run's device from the
seed, in a few large calls, so the same seed gives the same inputs and
set-up stays short. The subjects and heads are frozen copies of
`SubjectBank.add_debug_subject` and of chip_smoke.py's
`procedural_head`, `serve_affine` and `lesion_blob`, drawn on the device.
"""

from __future__ import annotations

import gzip
import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

# independent streams of one seed
_WEIGHTS, _SUBJECTS, _HEADS = 1, 2, 3


def generator(seed: int, stream: int, device, index: int = 0):
    """The torch.Generator of one input stream of `seed` (any integer)."""
    s = np.random.SeedSequence((int(seed) % 2 ** 64, stream, index))
    return torch.Generator(device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def weight_specs(model):
    """(name, shape) of every parameter, sorted by name: the order the
    weights are drawn in, the same for any model with these names."""
    return sorted((n, tuple(p.shape)) for n, p in model.named_parameters())


def seed_weights(specs, seed: int, device) -> dict:
    """float32 weights for `specs` from one normal draw: GroupNorm scales
    1 + 0.1 n, GroupNorm shifts 0.1 n, convolution weights n / sqrt(fan
    in), their biases 0.01 n."""
    g = generator(seed, _WEIGHTS, device)
    total = sum(math.prod(s) for _, s in specs)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if name.endswith("groupnorm.weight"):
            t = 1.0 + 0.1 * t
        elif name.endswith("groupnorm.bias"):
            t = 0.1 * t
        elif len(shape) >= 2:
            t = t / math.sqrt(math.prod(shape[1:]))
        else:
            t = 0.01 * t
        out[name] = t
    return out


@torch.no_grad()
def load_weights(model, weights: dict):
    """Copy `weights` into `model`'s parameters; the names must match."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weight names differ: {sorted(set(params) ^ set(weights))[:8]}")
    for n, p in params.items():
        p.copy_(weights[n])


def _grid(extent, device):
    ax = [torch.linspace(-1, 1, n, device=device, dtype=torch.float64)
          for n in extent]
    return torch.meshgrid(*ax, indexing="ij")


def _pad(vol, shape):
    out = vol.new_zeros(tuple(shape) + tuple(vol.shape[3:]))
    out[:vol.shape[0], :vol.shape[1], :vol.shape[2]] = vol
    return out


@torch.no_grad()
def label_subject(seed: int, index: int, extent, bank_shape, device,
                  lesion: bool = False) -> dict:
    """One procedural subject as `SubjectBank` stores it (numpy arrays
    padded to `bank_shape`): generation labels, segmentation, T1 (and
    image), 4 distance maps, 3 MNI coordinates, the extent, an age; with
    `lesion` also a lesion probability ('pathol_prob'). A sphere of white
    matter in a grey shell around a CSF core with six labelled blobs, as
    `add_debug_subject` draws it, at places and sizes drawn from the
    seed."""
    g = generator(seed, _SUBJECTS, device, index)
    zz, yy, xx = _grid(extent, device)
    r = torch.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    gen = torch.zeros(tuple(extent), dtype=torch.int32, device=device)
    gen[r < 0.8] = 3
    gen[r < 0.6] = 2
    gen[r < 0.2] = 4
    u = torch.rand(6, 4, generator=g, device=device, dtype=torch.float64)
    for lab, (a, b, c, s) in zip((10, 11, 12, 13, 17, 18), u):
        rr = torch.sqrt((xx - (0.8 * a - 0.4)) ** 2 + (yy - (0.8 * b - 0.4))
                        ** 2 + (zz - (0.8 * c - 0.4)) ** 2)
        gen[rr < 0.05 + 0.07 * s] = lab
    noise = torch.randn(tuple(extent), generator=g, device=device)
    t1 = (gen > 0).float() * (100 + 50 * noise).clamp(min=0)
    dist = (128 + 20 * (r - 0.7)).float()[..., None].expand(
        *extent, 4).contiguous()
    reg = torch.stack([xx, yy, zz], -1).float() * 10000
    vols = {"gen": gen, "seg": gen, "T1": t1, "image": t1, "dist": dist,
            "reg": reg}
    if lesion:
        vols["pathol_prob"] = lesion_blob(extent, g, device)
    subj = {k: _pad(v, bank_shape).cpu().numpy() for k, v in vols.items()}
    subj["shape"] = np.asarray([min(s, b) for s, b in zip(extent, bank_shape)],
                               np.float32)
    subj["age"] = np.float32(20.0 + 70.0 * float(torch.rand(
        (), generator=g, device=device, dtype=torch.float64)))
    return subj


def lesion_blob(shape, g, device):
    """A lesion probability (float32): a smooth ellipsoidal blob in [0, 1]
    with radii 0.12-0.25 and a centre within 0.35 of the middle."""
    x, y, z = _grid(shape, device)
    u = torch.rand(2, 3, generator=g, device=device, dtype=torch.float64)
    c = 0.7 * u[0] - 0.35
    r = 0.12 + 0.13 * u[1]
    d2 = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 \
        + ((z - c[2]) / r[2]) ** 2
    return (1.0 - d2).clamp(min=0.0).float()


def serve_affine(shape, voxel_mm, axes):
    """Voxel -> RAS affine: voxel axis j runs along axes[:, j] with spacing
    voxel_mm[j], the volume centred on the origin."""
    aff = np.eye(4)
    aff[:3, :3] = np.asarray(axes, np.float64) * np.asarray(voxel_mm,
                                                             np.float64)
    aff[:3, 3] = -aff[:3, :3] @ ((np.asarray(shape) - 1) / 2.0)
    return aff


@torch.no_grad()
def procedural_head(shape, voxel_mm, seed: int, index: int, device):
    """A head-like float32 volume (numpy): an ellipsoid of smooth brain
    texture in a brighter shell on a zero background, with noise; radii in
    mm, so the head fills about 3/4 of a 240 mm field."""
    g = generator(seed, _HEADS, device, index)
    ax = [(torch.arange(n, device=device, dtype=torch.float32) - (n - 1) / 2)
          * v for n, v in zip(shape, voxel_mm)]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    ext = [n * v for n, v in zip(shape, voxel_mm)]
    r = torch.sqrt((x / (0.36 * ext[0])) ** 2 + (y / (0.42 * ext[1])) ** 2
                   + (z / (0.33 * ext[2])) ** 2)
    coarse = torch.randn((1, 1, 9, 9, 9), generator=g, device=device)
    tex = F.interpolate(coarse, size=tuple(shape), mode="trilinear",
                        align_corners=True)[0, 0]
    vol = torch.where(r < 0.9, 70 + 25 * tex, 0.0)
    vol = vol + torch.where((r >= 0.9) & (r < 1.0), 110.0, 0.0)
    vol = vol + 3 * torch.randn(tuple(shape), generator=g, device=device) \
        * (r < 1.0)
    return vol.clamp(min=0).cpu().numpy()


def write_nifti_gz(path, vol, affine):
    """A NIfTI-1 float32 volume with its sform, gzip level 1."""
    vol = np.asarray(vol, np.float32)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = np.zeros(8, np.int16)
    dim[0] = vol.ndim
    dim[1:1 + vol.ndim] = vol.shape
    hdr[40:56] = dim.tobytes()
    struct.pack_into("<hh", hdr, 70, 16, 32)          # float32, 32 bits
    pixdim = np.ones(8, np.float32)
    pixdim[1:4] = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(0))
    hdr[76:108] = pixdim.tobytes()
    struct.pack_into("<fff", hdr, 108, 352.0, 1.0, 0.0)  # offset, slope, inter
    struct.pack_into("<hh", hdr, 252, 0, 1)           # qform 0, sform 1
    hdr[280:328] = np.asarray(affine, np.float32)[:3, :].tobytes()
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr))
        f.write(vol.tobytes(order="F"))
