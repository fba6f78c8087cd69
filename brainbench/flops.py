"""Analytic operation and byte counts of the BrainFM models, from the
configuration alone.

The yardstick of the rooflines and of `mfu.*`: the work a configuration
needs, counted from its shapes, never from what the program executes, so
a later change to the program (a recomputation removed, a kernel fused)
moves the time and not the count. Conventions are `FlopCounterMode`'s:
a convolution costs 2 x in x out x taps x output voxels; its backward the
same again for the input's gradient and again for the weight's (the first
convolution's input is a GroupNorm's output, whose scale and shift need
that gradient). Nothing else is counted.

GroupNorm bytes are the least a GroupNorm pass must move: the forward
reads its input once and writes its output once, in the input's dtype;
the backward reads the input and the output's gradient and writes the
input's gradient (the network's first GroupNorm writes none). Under bf16
autocast every GroupNorm input is a convolution's bf16 output, but the
first, which is the float32 network input. A decoder level whose upsample
is an exact 2x on every axis normalises the pair (skip, coarse) without
the upsampled copy (the configuration's `phase_upconv`, on by default):
its input is the skip plus the coarse tensor.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def _levels(size, num_levels):
    """Spatial extents of every level: max-pool 2 floors each axis."""
    out = [tuple(int(s) for s in size)]
    for _ in range(num_levels - 1):
        out.append(tuple(s // 2 for s in out[-1]))
    return out


def _conv(cin, cout, vox, k=27):
    return 2 * cin * cout * k * vox


def _widths(cfg):
    f = int(cfg.get("f_maps") or 64)
    n = int(cfg.get("num_levels") or 5)
    return [f * 2 ** k for k in range(n)]


def _encoder_convs(cfg, size):
    """(cin, cout, voxels, first of the network) of every encoder
    convolution."""
    fm = _widths(cfg)
    lv = _levels(size, len(fm))
    out = []
    cin = int(cfg.get("in_channels") or 1)
    for i, c in enumerate(fm):
        prev = cin if i == 0 else fm[i - 1]
        mid = max(c // 2, prev)
        v = math.prod(lv[i])
        out += [(prev, mid, v, i == 0), (mid, c, v, False)]
    return out


def _decoder_convs(cfg, size):
    fm = _widths(cfg)
    lv = _levels(size, len(fm))
    rev = fm[::-1]
    out = []
    for i in range(len(fm) - 1):
        v = math.prod(lv[len(fm) - 2 - i])
        cin, cout = rev[i + 1] + rev[i], rev[i + 1]
        out += [(cin, cout, v), (cout, cout, v)]
    return out


def _heads(cfg):
    """Output channels of each task head (the sep model has two)."""
    tasks = [k for k, v in dict(cfg["task"]).items() if v]
    left = bool(cfg["generator"].get("left_hemis_only"))
    n_labels = 18 if left else 56
    ch = {"T1": 1, "T2": 1, "FLAIR": 1, "CT": 1, "bias_field": 1,
          "segmentation": n_labels, "distance": 2 if left else 4,
          "registration": 3, "pathology": 1}
    unknown = set(tasks) - set(ch)
    if unknown:
        raise ValueError(f"no count for the tasks {sorted(unknown)}")
    outs = {t: ch[t] for t in tasks}
    if "sep" in str(cfg.get("backbone") or "unet3d"):
        return [sum(v for k, v in outs.items() if k != "pathology"),
                outs.get("pathology", 0)]
    return [sum(outs.values())]


def _convs(cfg, size):
    """Every convolution of one sample's forward: (cin, cout, voxels,
    taps)."""
    n_dec = 2 if "sep" in str(cfg.get("backbone") or "unet3d") else 1
    convs = [c[:3] + (27,) for c in _encoder_convs(cfg, size)]
    convs += [c + (27,) for c in _decoder_convs(cfg, size)] * n_dec
    f = int(cfg.get("f_maps") or 64)
    tfm = list(cfg.get("task_f_maps") or [64])
    chans = [f] + tfm[1:]
    v0 = math.prod(int(s) for s in size)
    for n_out in _heads(cfg):
        convs += [(a, b, v0, 27) for a, b in zip(chans[:-1], chans[1:])]
        convs.append((chans[-1], n_out, v0, 1))
    return convs


def forward_flops(cfg, size) -> int:
    """One sample's forward at spatial `size`."""
    return sum(_conv(a, b, v, k) for a, b, v, k in _convs(cfg, size))


def step_flops(cfg, size) -> int:
    """One sample's forward and backward (no recomputation)."""
    return 3 * forward_flops(cfg, size)


def train_flops_per_item(cfg) -> int:
    """An item: `all_samples` samples at the crop, forward and backward."""
    gen = cfg["generator"]
    return int(gen["all_samples"]) * step_flops(cfg, gen["size"])


def gn_inputs(cfg, size):
    """(elements, bytes per element, input needs no gradient) of every
    GroupNorm's input in one sample's forward under bf16 autocast on the
    card (where max-pooling keeps bf16)."""
    fm = _widths(cfg)
    lv = _levels(size, len(fm))
    n_dec = 2 if "sep" in str(cfg.get("backbone") or "unet3d") else 1
    pair = bool(cfg.get("phase_upconv", True) is not False)
    out = []
    for cin, cout, v, first in _encoder_convs(cfg, size):
        out.append((cin * v, 4 if first else 2, first))
    rev = fm[::-1]
    for _ in range(n_dec):
        for i in range(len(fm) - 1):
            fine, coarse = lv[len(fm) - 2 - i], lv[len(fm) - 1 - i]
            vf, vc = math.prod(fine), math.prod(coarse)
            skip, low, cout = rev[i + 1], rev[i], rev[i + 1]
            exact = pair and cout <= 256 and all(
                f == 2 * c and c > 0 for f, c in zip(fine, coarse))
            first_in = skip * vf + low * (vc if exact else vf)
            out += [(first_in, 2, False), (cout * vf, 2, False)]
    return out


def gn_forward_bytes(cfg, size) -> int:
    """One sample's GroupNorm forward passes: input read, output written."""
    return sum(2 * n * b for n, b, _ in gn_inputs(cfg, size))


def gn_backward_bytes(cfg, size) -> int:
    """One sample's GroupNorm backward passes: input and output gradient
    read, input gradient written (none for the network input)."""
    return sum((2 if first else 3) * n * b
               for n, b, first in gn_inputs(cfg, size))


def gn_train_bytes_per_item(cfg) -> int:
    gen = cfg["generator"]
    size = gen["size"]
    return int(gen["all_samples"]) * (gn_forward_bytes(cfg, size)
                                      + gn_backward_bytes(cfg, size))
