"""The whole data-parallel training step's share of the cards' bf16 peak:
the configuration's analytic forward and backward FLOPs per item (no
recomputation, brainbench/flops.py) times the world's items completed,
over the window's seconds, over the ranks' cards (the traffic's `ranks`)
at 989 TFLOP/s each (H100 SXM data sheet, dense)."""

from brainbench import flops


def read(w):
    if not w.done or w.seconds <= 0:
        return None
    cards = int(w.traffic["ranks"])
    return (100.0 * flops.train_flops_per_item(w.cfg) * w.done / w.seconds
            / (cards * flops.PEAK_BF16_FLOPS))
