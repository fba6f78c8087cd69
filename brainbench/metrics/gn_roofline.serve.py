"""The GroupNorm kernels' share of their memory roofline in serving: the
least bytes of the forward's GroupNorm passes at the served window
(brainbench/flops.py) times the volumes, at 3.35 TB/s, over the device
time of the kernels named here (K3, K4 of csrc/groupnorm.cu, and the
library GroupNorm's forward) in the trace."""

from brainbench import flops

KERNELS = ("sums_kernel", "sums_finish", "affine_kernel", "RowwiseMoments",
           "ComputeFusedParams")


def read(w):
    if w.timeline is None or not w.done:
        return None
    t = w.timeline.seconds_of(KERNELS)
    if t <= 0:
        return None
    least = flops.gn_forward_bytes(w.cfg, w.traffic["win"]) * w.done
    return 100.0 * least / flops.PEAK_HBM_BYTES_PER_S / t
