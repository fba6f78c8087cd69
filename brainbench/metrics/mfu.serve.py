"""The served forward's share of the card's bf16 peak: the configuration's
analytic forward FLOPs at the served window (brainbench/flops.py) times
the volumes served, over the window's seconds, over 989 TFLOP/s."""

from brainbench import flops


def read(w):
    if not w.done or w.seconds <= 0:
        return None
    f = flops.forward_flops(w.cfg, w.traffic["win"])
    return 100.0 * f * w.done / w.seconds / flops.PEAK_BF16_FLOPS
