"""The served two-stage pair's share of the card's bf16 peak: both stages'
analytic forward FLOPs at the served window (brainbench/flops_twostage.py)
times the volumes served, over the window's seconds, over 989 TFLOP/s."""

from brainbench import flops, flops_twostage


def read(w):
    if not w.done or w.seconds <= 0:
        return None
    f = flops_twostage.forward_flops(w.cfg, w.traffic["win"])
    return 100.0 * f * w.done / w.seconds / flops.PEAK_BF16_FLOPS
