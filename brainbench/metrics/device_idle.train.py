"""The share of the traced training window in which no kernel, copy or set
ran on the card."""


def read(w):
    if w.timeline is None or w.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.timeline.busy_s / w.timeline.window_s)
