"""What this card delivers, and what the flagship's work counts.

    python -m brainfm_tpu_torch.scripts.roofline              # on CUDA

The port's twin of the root `scripts/roofline.py`, of the "~21 bf16
TFLOP" of `scripts/profile_infer.py` and of `scripts/profile_train.py
--cost`. One JSON line per probe, each with the card's name and power
limit:

- rates, each the median of REPS calls after WARMUP calls, a pair of
  CUDA events around each (`utils/profiling.py::call_times`): the bf16
  matmul at the root script's size (TF/s); the 3^3 bf16 conv3d at the
  flagship's three widest-traffic shapes (TF/s), in the NCDHW layout the
  port's model runs and in `channels_last_3d`; the
  elementwise bf16 `x*1.0001+0.1` at 220^3 x 64 (GB/s, one read and one
  write of each element); `nn.GroupNorm(8)` then `leaky_relu` at 220^3 x
  64 as the port runs it (bf16 input under bf16 autocast, which runs the
  norm in fp32 and hands back fp32; GB/s over one read of the input and
  one write of the output);
- FLOP counts (`torch.utils.flop_counter.FlopCounterMode`: convolutions
  and matrix products, forward and backward, with any recompute): the
  220^3 L6 whole-volume forward of the bench's served model on the meta
  device, and the bench's two train steps (its 128^3 step and the
  flagship 160^3 S=4 step: forward, criterion and backward, under bf16
  autocast) on the device, which autocast needs.

A reading above `PEAK` (the H100 SXM data sheet: 989 TF/s dense bf16,
3.35 TB/s HBM) would be a timing fault; `chip_smoke.py` checks that none
passes 105 % of it. The library calls here are measurements, not ports.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch
import torch.nn.functional as F

from brainfm_tpu_torch import bench
from brainfm_tpu_torch.device import card_label, resolve_device
from brainfm_tpu_torch.utils.profiling import call_times

PEAK = {"tflops": 989.0, "gbps": 3350.0}
WARMUP, REPS = 3, 10
MATMUL = 8192
CONVS = ((220, 64, 64), (110, 128, 128), (55, 256, 256))
VOXELS, CHANNELS, GROUPS = 220, 64, 8


def device_ms(fn, dev) -> float:
    """The median ms of a call of fn() on `dev`."""
    return statistics.median(call_times(fn, dev, REPS, WARMUP))


def count_flops(fn) -> tuple[int, dict]:
    """(total FLOPs, {aten op: FLOPs}) of what fn() runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), {
        str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


def forward_flops(model, x) -> tuple[int, dict]:
    """FLOPs of model(x) without gradients."""
    def run():
        with torch.no_grad():
            model(x)
    return count_flops(run)


def step_flops(cfg, batch, dev) -> tuple[int, dict]:
    """FLOPs of one train step's forward, criterion and backward (the
    optimizer's elementwise update is not counted) on `batch`, the model
    built from `cfg` on `dev` with bf16 autocast as the step runs it. The
    S samples go through one at a time, as `sample_accum=S` runs them:
    the counted operations are per sample, so the sum is the S-sample
    step's, and the counter's bookkeeping holds one sample's
    activations (a 160^3 S=4 step under the counter does not fit the
    card whole)."""
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.models.criterion import (make_criterion,
                                                    weighted_total)
    from brainfm_tpu_torch.train.step import batch_losses, split_samples

    cfg, model = build_model(cfg, device=dev)
    _, weights, loss_fn = make_criterion(cfg)
    model.train()
    S = batch["samples"]["input"].shape[1]

    def run():
        for i in range(S):
            total = weighted_total(batch_losses(
                model, cfg, loss_fn, split_samples(batch, i, S), amp=True),
                weights)
            total.backward()
            del total
    return count_flops(run)


def _zeros_batch(size, S, dev):
    """A train batch of the step's shapes (its values change no count)."""
    def z(*s):
        return torch.zeros(s, device=dev)
    return {"samples": {"input": z(1, S, *size, 1),
                        "bias_field_log": z(1, S, *size, 1)},
            "targets": {"T1": z(1, 1, *size, 1),
                        "segmentation": z(1, 1, *size, 56),
                        "distance": z(1, 1, *size, 4),
                        "registration": z(1, 1, *size, 3)}}


def probes(dev):
    """(name, record) for each rate probe."""
    def randn(*s, dtype=torch.bfloat16):
        return torch.randn(*s, device=dev, dtype=torch.float32).to(dtype)

    m = MATMUL
    a, b = randn(m, m), randn(m, m)
    ms = device_ms(lambda: a @ b, dev)
    yield f"matmul bf16 {m}^3", {"ms": ms, "tflops": 2.0 * m ** 3 / ms / 1e9}
    del a, b

    for s, cin, cout in CONVS:
        w = randn(cout, cin, 3, 3, 3) * 0.01
        flops = 2.0 * s ** 3 * cin * cout * 27
        for layout in ("ncdhw", "channels_last_3d"):
            x = randn(1, cin, s, s, s)
            if layout != "ncdhw":
                x = x.to(memory_format=torch.channels_last_3d)
                wl = w.to(memory_format=torch.channels_last_3d)
            else:
                wl = w
            ms = device_ms(lambda: F.conv3d(x, wl, padding=1), dev)
            yield (f"conv3d bf16 {s}^3 x{cin}->{cout} 3^3 {layout}",
                   {"ms": ms, "tflops": flops / ms / 1e9})
            del x

    v = VOXELS
    x = randn(1, CHANNELS, v, v, v)
    # one kernel, 0.1 + 1.0001 * x: a 0-dim CPU tensor enters a CUDA
    # kernel as a scalar (a 0-dim CUDA one would be a strided input)
    shift = torch.tensor(0.1, dtype=torch.bfloat16)
    ms = device_ms(lambda: torch.add(shift, x, alpha=1.0001), dev)
    nbytes = 2 * x.numel() * x.element_size()
    yield (f"elementwise bf16 x*1.0001+0.1 {v}^3x{CHANNELS}",
           {"ms": ms, "gbps": nbytes / ms / 1e6, "bytes": nbytes})

    gn = torch.nn.GroupNorm(GROUPS, CHANNELS, eps=1e-5).to(dev)

    def gn_chain():
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            return F.leaky_relu(gn(x), 0.01)

    with torch.no_grad():
        out_dtype = gn_chain().dtype
        ms = device_ms(gn_chain, dev)
    nbytes = x.numel() * (x.element_size() + out_dtype.itemsize)
    yield (f"groupnorm{GROUPS}+leakyrelu {v}^3x{CHANNELS}",
           {"ms": ms, "gbps": nbytes / ms / 1e6, "bytes": nbytes,
            "out_dtype": str(out_dtype).removeprefix("torch.")})


def flop_counts(dev):
    """(name, record) for the forward's and the two steps' FLOP counts."""
    from brainfm_tpu_torch.models import build_model
    from brainfm_tpu_torch.synth import SynthStatic

    shape = bench.SHAPES["full"]
    vol = (shape["vol"],) * 3
    _, model = build_model(bench.model_cfg(bench.INFER_CFG, shape,
                                           shape["win"]), device="meta")
    total, ops = forward_flops(model, torch.empty((1, *vol, 1),
                                                  device="meta"))
    yield f"forward {vol[0]}^3 L{shape['num_levels']} f{shape['f_maps']}", {
        "flops": total, "tflop": total / 1e12, "by_op": ops,
        "counted_on": "meta"}
    del model

    tcfg = bench.model_cfg(bench.TRAIN_CFG, shape, shape["train_size"])
    steps = [(f"train step {shape['train_size'][0]}^3 S=1 (bench "
              "train_step_ms)", tcfg, shape["train_size"], 1)]
    fcfg = bench.flagship_cfg(False)
    fs = SynthStatic.from_cfg(fcfg)
    steps.append((f"train step {fs.size[0]}^3 S={fs.all_samples} flagship "
                  "(bench train_step_flagship_ms)", fcfg, tuple(fs.size),
                  fs.all_samples))
    for name, cfg, size, S in steps:
        total, ops = step_flops(cfg, _zeros_batch(size, S, dev), dev)
        yield name, {"flops": total, "tflop": total / 1e12, "by_op": ops,
                     "remat": cfg.get("remat"), "counted_on": dev.type}
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: CUDA")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    for kind, gen in (("rate", probes(dev)), ("flops", flop_counts(dev))):
        for name, rec in gen:
            for k, peak in PEAK.items():
                if k in rec:
                    rec[f"{k}_share_of_peak"] = rec[k] / peak
            print(json.dumps({"probe": name, "kind": kind, **rec,
                              "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
