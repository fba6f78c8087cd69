"""The whole training iteration's share of the card's bf16 peak: the
configuration's analytic forward and backward FLOPs per item (no
recomputation, brainbench/flops.py) times the items completed, over the
window's seconds, over 989 TFLOP/s (H100 SXM data sheet, dense)."""

from brainbench import flops


def read(w):
    if not w.done or w.seconds <= 0:
        return None
    return (100.0 * flops.train_flops_per_item(w.cfg) * w.done / w.seconds
            / flops.PEAK_BF16_FLOPS)
