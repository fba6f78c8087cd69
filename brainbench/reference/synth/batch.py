"""Train batches from synthesized items (port of `stack_items`,
brainfm_tpu/synth/sharded.py). The per-rank sharded synthesis of that file
is synth/sharded.py, which re-exports this."""

from __future__ import annotations

import torch


def stack_items(targets, samples):
    """Stack per-item (target, samples) dicts into one train batch.

    Volume targets (3 or more dims) gain the (B, 1, ...) sample axis the
    criterion broadcasts against; host-side-only targets (surface
    deformation state, the float pathology prior) are dropped."""
    tgt = {}
    for k in targets[0]:
        if k == "pathology_prob" or k.startswith("surface_"):
            continue
        xs = [torch.as_tensor(t[k]) for t in targets]
        st = torch.stack(xs)
        tgt[k] = st[:, None] if xs[0].dim() >= 3 else st
    smp = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    return {"targets": tgt, "samples": smp}
