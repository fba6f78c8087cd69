"""The GroupNorm kernels' share of their memory roofline in training: the
least bytes of the configuration's GroupNorm passes (forward and backward,
no recomputation; brainbench/flops.py) per item, times the items, at
3.35 TB/s, over the device time of the kernels named here (the port's
K3-K5 of csrc/groupnorm.cu, and the library GroupNorm's) in the trace.
Nothing traced under these names: no reading."""

from brainbench import flops

KERNELS = ("sums_kernel", "sums_finish", "affine_kernel", "affine3_kernel",
           "RowwiseMoments", "ComputeFusedParams",
           "ComputeInternalGradients", "ComputeBackwardFusedParams",
           "GammaBeta", "GroupNormBackward")


def read(w):
    if w.timeline is None or not w.done:
        return None
    t = w.timeline.seconds_of(KERNELS)
    if t <= 0:
        return None
    least = flops.gn_train_bytes_per_item(w.cfg) * w.done
    return 100.0 * least / flops.PEAK_HBM_BYTES_PER_S / t
