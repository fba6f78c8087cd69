"""Milliseconds of the card's work per served volume: the traced window's
device busy time (the resample in infer/prepare.py, the forward of
Inferencer._forward through models/, postprocess with K2, the copy to the
host) over the volumes served."""


def read(w):
    if w.timeline is None or not w.done:
        return None
    return w.timeline.busy_s * 1e3 / w.done
