"""Per-rank sharded batch synthesis (port of brainfm_tpu/synth/sharded.py).

In a mesh run every data rank makes only its own items of the batch: rank
r of n makes items r*B/n ... (r+1)*B/n - 1, each from its own generator,
on the rank's device, so K1 and K2 run on every rank and no item crosses
a process. The ranks of one space group make the same items. The shard
equals the same rows of a serial `make_batch` over the same generators,
bitwise: an item depends only on its generator, its subject and the
static config.
"""

from __future__ import annotations

from ..parallel.mesh import axis_index, axis_size
from .batch import stack_items
from .engine import synth_item

__all__ = ["sharded_synth_batch", "stack_items"]


def local_items(mesh, B: int, axes=("data",)) -> range:
    """The item positions of a B-item batch that this rank makes."""
    n, r = 1, 0
    for a in axes:
        n, r = n * axis_size(mesh, a), r * axis_size(mesh, a) + axis_index(
            mesh, a)
    if B % n:
        raise ValueError(f"a batch of {B} items does not split over "
                         f"{n} ranks of {axes}")
    m = B // n
    return range(r * m, (r + 1) * m)


def sharded_synth_batch(mesh, generators, subject, scfg, tasks, input_mode,
                        knobs, axes=("data",), per_item_subject: bool = False):
    """This rank's rows of a B-item train batch, B = len(generators), a
    multiple of the ranks over `axes`. `subject`: one subject dict shared
    by every item or, with `per_item_subject=True`, a list of B subject
    dicts (only this rank's entries are read; the others may be None).
    `input_mode` is one mode or a list of B (a mixed-modality batch);
    `knobs` likewise one knob stack or a list of B. Returns stack_items
    over this rank's items."""
    B = len(generators)
    targets, samples = [], []
    for i in local_items(mesh, B, axes):
        subj = subject[i] if per_item_subject else subject
        mode = input_mode[i] if isinstance(input_mode, list) else input_mode
        kn = knobs[i] if isinstance(knobs, list) else knobs
        t, s = synth_item(generators[i], subj, scfg, tuple(tasks), mode, kn)
        targets.append(t)
        samples.append(s)
    return stack_items(targets, samples)
