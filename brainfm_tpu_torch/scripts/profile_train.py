"""Train-step timing across remat modes on the flagship L6 model (the
port's twin of the repo's `scripts/profile_train.py`).

    python -m brainfm_tpu_torch.scripts.profile_train            # CUDA, 128^3
    python -m brainfm_tpu_torch.scripts.profile_train --modes off,full,save_convs
    python -m brainfm_tpu_torch.scripts.profile_train --ledger
    python -m brainfm_tpu_torch.scripts.profile_train --size 16 --f_maps 8 \\
        --levels 3 --reps 1 --device cpu                        # smoke

The step is train/step.py's: AdamW (lr 1e-4), clip 1.0, bf16 autocast,
on the root script's joint config and its `default_rng(1)` batch (one
128^3 item, S=1), with `cfg.remat` at each mode:

  off          save every activation (most memory)
  full         recompute each DoubleConv block in the backward pass
  save_convs   keep the convolutions' outputs, recompute only the
               GroupNorm / LeakyReLU chain (models/unet3d.py)

A timed mode prints `<mode> <ms> ms / step @<s>^3 L<levels> f<f_maps>`:
the mean of `--reps` steps after one warm-up, on the host clock between
two `torch.cuda.synchronize()` calls. A mode that fails (running out of
memory included) prints `<mode> FAILED: <type>: <msg>`; its state is
freed and the sweep goes on.

`--ledger` runs one whole step per mode under two counters instead of
timing it:

- FLOPs under `torch.utils.flop_counter.FlopCounterMode` (convolutions
  and matrix products, forward and backward); the recompute of
  `torch.utils.checkpoint` runs inside the backward, so it is counted, as
  XLA's count of the JAX step includes its remat;
- bytes under `TensorBytes`, a `TorchDispatchMode` that adds up the bytes
  of every operation's tensor inputs and outputs (views, which move
  nothing, left out): the aten operations and the port's own operators,
  K3-K5 of the GroupNorm (`brainfm.chan_sums`, `chan_affine`,
  `chan_affine3`) and the decoder's pair conv
  (`brainfm.phase_pair_conv`). Eager PyTorch fuses nothing else, so this
  is what the step's kernels read and write before cache hits; it is not
  XLA's post-fusion `bytes accessed`, which the JAX script prints.

It prints the root script's two lines per mode: TF and GiB (with the
exact counts), then the parameter count and the AdamW traffic of 7 fp32
streams over it (read p, m, v, g; write p, m, v).
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

MODES = {"off": False, "full": True, "save_convs": "save_convs"}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--f_maps", type=int, default=64)
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--modes", default="full,save_convs",
                    help="comma list from {off,full,save_convs}")
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--ledger", action="store_true",
                    help="count each mode's FLOPs (recompute included) and "
                         "bytes over one step instead of timing it")
    return ap


def parse_modes(ap, text):
    modes = [m.strip() for m in text.split(",") if m.strip()]
    bad = [m for m in modes if m not in MODES]
    if bad:
        ap.error(f"unknown --modes {bad}; valid: {sorted(MODES)}")
    return modes


def step_cfg(size: int, f_maps: int, levels: int, remat):
    """The root script's config (its `task_f_maps` stays [64])."""
    from brainfm_tpu_torch.config import AttrDict

    ts = [size] * 3
    return AttrDict.from_nested({
        "task": {"T1": True, "segmentation": True, "distance": True,
                 "registration": True, "bias_field": True},
        "generator": {"left_hemis_only": False, "size": ts},
        "losses": {"uncertainty": None, "image_grad": True,
                   "registration_grad": True, "bias_field_log_type": "l2"},
        "weights": {k: 1.0 for k in ("seg_ce", "seg_dice", "image",
                                     "image_grad", "bias_field_log",
                                     "distance", "registration",
                                     "registration_grad")},
        "backbone": "unet3d", "f_maps": f_maps, "num_levels": levels,
        "num_groups": 8, "layer_order": "gcl", "unit_feat": False,
        "task_f_maps": [64], "max_surf_distance": 3.0,
        "label_list_segmentation_with_csf": [0, 14, 15, 16, 24, 77, 85],
        "optimizer": "adamw", "lr": 1e-4, "weight_decay": 0.0,
        "clip_max_norm": 1.0, "all_samples": 1, "remat": remat})


def root_batch(size: int, dev):
    """The root script's batch: one item, S=1, from default_rng(1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    ts = (size,) * 3
    xt = rng.random((1, *ts, 1))
    t1 = rng.random((1, 1, *ts, 1))
    seg = np.eye(56, dtype=np.float32)[rng.integers(0, 56, (1, 1, *ts))]
    dist = rng.random((1, 1, *ts, 4))
    reg = rng.random((1, 1, *ts, 3))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return {"samples": {"input": t(xt[None]),
                        "bias_field_log": t(np.zeros((1, 1, *ts, 1)))},
            "targets": {"T1": t(t1), "segmentation": t(seg),
                        "distance": t(dist), "registration": t(reg)}}


def make_step(cfg, dev):
    """(state, step) of the root script's step: AdamW, clip 1.0, bf16."""
    import torch

    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.models.criterion import make_criterion
    from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                              make_train_step)

    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weights, loss_fn = make_criterion(cfg)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, weights, loss_fn, opt, amp=True)
    return TrainState(model, opt, 0), step


def _tensor_bytes_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    import torch

    class TensorBytes(TorchDispatchMode):
        """Adds up the bytes of every operation's tensor inputs and
        outputs (aten's and the port's custom operators); view operations
        move nothing and are left out."""

        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.bytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            return out

    return TensorBytes()


def ledger_mode(cfg, batch, dev) -> dict:
    """FLOPs and bytes of one whole step of `cfg`, and the parameter
    count."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    state, step = make_step(cfg, dev)
    n_par = sum(p.numel() for p in state.model.parameters())
    counter = _tensor_bytes_mode()
    with FlopCounterMode(display=False) as flops, counter:
        step(state, batch, 1e-4, 0.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return {"flops": flops.get_total_flops(), "bytes": counter.bytes,
            "params": n_par}


def time_mode(cfg, batch, dev, reps: int) -> float:
    """The mean ms of `reps` steps after one warm-up."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, step = make_step(cfg, dev)
    step(state, batch, 1e-4, 0.0)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch, 1e-4, 0.0)
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def _free(dev):
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sweep(args, modes, dev):
    """Each mode timed (or counted, with `args.ledger`); prints the root
    script's lines and returns {mode: record}, a record holding `ms` (or
    `flops`, `bytes`, `params`) or `failed`."""
    batch = root_batch(args.size, dev)
    tail = f"@{args.size}^3 L{args.levels} f{args.f_maps}"
    out = {}
    for mode in modes:
        cfg = step_cfg(args.size, args.f_maps, args.levels, MODES[mode])
        try:
            if args.ledger:
                rec = ledger_mode(cfg, batch, dev)
                print(f"{mode:<12s} flops {rec['flops'] / 1e12:8.2f} TF   "
                      f"bytes {rec['bytes'] / 2**30:7.2f} GiB {tail} "
                      f"({rec['flops']} FLOP, {rec['bytes']} B)", flush=True)
                opt_gb = 7 * 4 * rec["params"] / 1e9
                print(f"{'':<12s} params {rec['params'] / 1e6:.1f} M -> "
                      f"adamw traffic ~{opt_gb:.1f} GB/step (7 fp32 streams)",
                      flush=True)
            else:
                rec = {"ms": time_mode(cfg, batch, dev, args.reps)}
                print(f"{mode:<12s} {rec['ms']:9.1f} ms / step {tail}",
                      flush=True)
        except Exception as e:   # noqa: BLE001 - out of memory included
            rec = {"failed": f"{type(e).__name__}: {e}"}
            print(f"{mode:<12s} FAILED: {rec['failed']}", flush=True)
        finally:
            # this mode's model, optimizer state and activations go
            # before the next mode allocates
            _free(dev)
        out[mode] = rec
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    modes = parse_modes(ap, args.modes)

    from brainfm_tpu_torch.device import resolve_device

    sweep(args, modes, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
