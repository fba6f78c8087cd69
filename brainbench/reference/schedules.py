"""LR / weight-decay schedules as precomputed arrays (a copy of
brainfm_tpu/train/schedules.py, which imports only numpy: the port imports
nothing of the JAX package).

The reference's multistep and cosine schedulers as per-iteration lookup
arrays, and the wiring that builds both from the trainer config.
"""

from __future__ import annotations

import numpy as np


def multistep_schedule(base_value, lr_drops, epochs, niter_per_ep,
                       warmup_epochs=0, start_warmup_value=0, gamma=0.1):
    warmup_iters = warmup_epochs * niter_per_ep
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters) \
        if warmup_epochs > 0 else np.array([])
    sched = np.ones(epochs * niter_per_ep - warmup_iters) * base_value
    for milestone in lr_drops:
        sched[milestone * niter_per_ep:] *= gamma
    out = np.concatenate([warmup, sched])
    assert len(out) == epochs * niter_per_ep
    return out.astype(np.float32)


def cosine_schedule(base_value, final_value, epochs, niter_per_ep,
                    warmup_epochs=0, start_warmup_value=0):
    warmup_iters = warmup_epochs * niter_per_ep
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters) \
        if warmup_epochs > 0 else np.array([])
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    sched = final_value + 0.5 * (base_value - final_value) * \
        (1 + np.cos(np.pi * iters / max(len(iters), 1)))
    out = np.concatenate([warmup, sched])
    assert len(out) == epochs * niter_per_ep
    return out.astype(np.float32)


def build_schedules(cfg, itr_per_epoch):
    """(lr, wd) per-iteration arrays from the trainer config."""
    if cfg.lr_scheduler == "cosine":
        lr = cosine_schedule(float(cfg.lr), float(cfg.min_lr),
                             int(cfg.n_epochs), itr_per_epoch,
                             warmup_epochs=int(cfg.warmup_epochs or 0))
    else:
        lr = multistep_schedule(float(cfg.lr), list(cfg.lr_drops or []),
                                int(cfg.n_epochs), itr_per_epoch,
                                warmup_epochs=int(cfg.warmup_epochs or 0),
                                gamma=float(cfg.lr_drop_multi or 0.1))
    wd = cosine_schedule(float(cfg.weight_decay or 0.0),
                         float(cfg.weight_decay_end or 0.0),
                         int(cfg.n_epochs), itr_per_epoch)
    return lr, wd
