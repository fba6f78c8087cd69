#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's flagship slice and of one
served volume on one GPU.

    python3 scripts/profile_torch_slice.py

Builds the same flagship item and L6 f_maps-64 model as chip_smoke.py
(cfgs brain_id + joint, 160^3 from a 192^3 bank, S=4, bf16 forward), runs
one warm-up pass, then profiles one synth_item and one forward, each in its
own torch.profiler session (CPU + CUDA activity). Then `profile_serve`: one
procedural head (chip_smoke.py's serve input) served whole at 220^3 by the
same model in bf16 through Inferencer.evaluate_path (serial, every output
but the segmentation written as .nii), once unprofiled and once profiled
after a warm-up. For each it prints one JSON line: host wall ms, the summed
device time of all GPU kernels (they run on one stream, so this is the
device's busy time), the idle share 1 - busy/wall (for serve also against
the unprofiled wall of the same run), the share of the port's own CUDA
kernels (csrc/), and the top kernels by device time. Then a cProfile of
one prepare_image call on the served file: its top host functions.

Then training (`fit_train`, `profile_train`): the flagship train step
(AdamW, bf16 autocast, S=4 at 160^3) under each memory setting in order,
remat 'save_convs' at grad_accum_samples 1, then 2, then remat 'full' at 2,
with the peak memory (allocated and reserved) and step time of each, or
the out-of-memory it met; the first whose peak allocated memory leaves
TRAIN_HEADROOM_GB of the card free is the one chip_smoke.py's train phase
uses. (The reserved peak adds the allocator's cached blocks, which it
frees and retries before it reports an out-of-memory.) One step at that
setting is profiled after a warm-up, with its device time by kernel family
(GroupNorm forward and backward, convolution forward, dgrad and wgrad, the
optimizer's foreach kernels, the rest).

The model variants (`fit_variants`): chip_smoke.py's variants (joint_age,
sep, the critic-on flagship) and the two-stage pair at full width, each
through fit_train over remat 'save_convs' at grad_accum_samples 1, 2 and
4 (those that divide its S); the settings it picks are chip_smoke.py's
VARIANT_FIT and TWOSTAGE_FIT.

    python3 scripts/profile_torch_slice.py              # everything
    python3 scripts/profile_torch_slice.py --train      # training only
    python3 scripts/profile_torch_slice.py --variants   # the variants' fit

Chrome traces go to outs/profile_torch_slice/ (git-ignored).
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (flagship config and constants)
from brainfm_tpu_torch.infer import Inferencer, prepare_image  # noqa: E402
from brainfm_tpu_torch.models import (apply_processors,  # noqa: E402
                                      build_critic_from_cfg,
                                      build_inpaint_model, build_model)
from brainfm_tpu_torch.models.criterion import make_criterion  # noqa: E402
from brainfm_tpu_torch.models.unet3d import DoubleConv, remat_mode  # noqa: E402
from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic,  # noqa: E402
                                     knobs_from_cfg, synth_item)
from brainfm_tpu_torch.train import (TrainState, build_optimizer,  # noqa: E402
                                     make_batch, make_train_step)
from brainfm_tpu_torch.utils.nifti import save_nifti  # noqa: E402

# kernel names of brainfm_tpu_torch/csrc
OWN = ("warp_linear_kernel", "warp_nearest_kernel", "lut_row_kernel",
       "lut_word_kernel", "lut_scalar_kernel")
TOP = 15


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# device-time families of a train step, by kernel name (first match)
FAMILIES = (("groupnorm_fwd", ("RowwiseMoments", "ComputeFusedParams")),
            ("groupnorm_bwd", ("ComputeInternalGradients",
                               "ComputeBackwardFusedParams", "GammaBeta",
                               "GroupNormBackward")),
            ("conv_dgrad", ("dgrad",)),
            ("conv_wgrad", ("wgrad",)),
            ("conv_fwd", ("fprop", "conv", "xmma", "implicit_gemm")),
            ("optimizer", ("multi_tensor_apply", "foreach", "Adam")),
            ("own_kernels", OWN),
            # index_select's backward (the decoders' nearest upsample)
            ("index_add", ("indexFunc",)),
            ("layout", ("nchwToNhwc", "nhwcToNchw")),
            ("copy_cast", ("copy_kernel",)),
            ("elementwise", ("elementwise_kernel", "reduce_kernel")))
TRAIN_HEADROOM_GB = 8.0
TRAIN_SETTINGS = (("save_convs", 1), ("save_convs", 2), ("full", 2))
VARIANT_SETTINGS = (("save_convs", 1), ("save_convs", 2), ("save_convs", 4))


def families(kern) -> dict:
    """Summed device ms per FAMILIES entry, the rest under 'other'."""
    out = {}
    for k, (us, _) in kern.items():
        fam = next((f for f, keys in FAMILIES
                    if any(key in k for key in keys)), "other")
        out[fam] = out.get(fam, 0.0) + us / 1e3
    return out


def breakdown(name, fn, out_dir, unprofiled_wall_ms=None, top=TOP):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    kern = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kern[evt.key] = (kern.get(evt.key, (0.0, 0))[0] + us,
                             kern.get(evt.key, (0.0, 0))[1] + evt.count)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    own_ms = sum(us for k, (us, _) in kern.items()
                 if any(o in k for o in OWN)) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]
    rec = {"phase": f"profile_{name}", "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if wall_ms > 0 else None,
           "own_kernels_ms": own_ms, "n_kernel_names": len(kern),
           "unprofiled_wall_ms": unprofiled_wall_ms,
           "idle_share_unprofiled": (None if unprofiled_wall_ms is None
                                     else 1 - busy_ms / unprofiled_wall_ms),
           "families_ms": families(kern),
           "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    print(json.dumps(rec), flush=True)
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")


def main():
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "outs", "profile_torch_slice")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    print(chip_smoke.gpu_name_power(), flush=True)
    if "--train" in sys.argv[1:]:
        profile_train(dev, out_dir)
        return 0
    if "--variants" in sys.argv[1:]:
        fit_variants(dev)
        return 0
    cfg = chip_smoke.flagship_cfg()
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    model.eval()
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank(chip_smoke.BANK)
    bank.add_debug_subject(seed=0)
    subj = bank.to_device(0, dev)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    gen = torch.Generator(dev).manual_seed(1)
    draws = {"setup": {"flip_n": 0.0}}
    held = {}

    def item():
        held["samples"] = synth_item(gen, subj, scfg, cfg.tasks, "synth",
                                     knobs, draws=draws)[1]

    def forward():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            apply_processors(model(held["samples"]["input"]), cfg)

    item()
    forward()
    breakdown("item", item, out_dir)
    breakdown("forward", forward, out_dir)
    profile_serve(cfg, model.state_dict(), dev, out_dir)
    del model, held
    profile_train(dev, out_dir)
    return 0


def _set_remat(model, remat):
    for m in model.modules():
        if isinstance(m, DoubleConv):
            m.remat = remat_mode(remat)


def fit_train(cfg, model, weight_dict, loss_fn, batch, dev,
              settings=TRAIN_SETTINGS, critic=None, label="flagship"):
    """One warm and one measured train step under each of `settings`
    (optimizer state made by the first step, so the measured one holds it
    all; a frozen `critic` takes the same remat); prints a line each and
    returns the first setting whose peak allocated memory leaves
    TRAIN_HEADROOM_GB of the card free."""
    total = torch.cuda.get_device_properties(dev).total_memory
    chosen = None
    for remat, accum in settings:
        for m in (model, critic):
            if m is not None:
                _set_remat(m, remat)
        torch.cuda.empty_cache()
        state = TrainState(model, build_optimizer(cfg, model.parameters()))
        step = make_train_step(model, cfg, weight_dict, loss_fn,
                               state.optimizer, sample_accum=accum,
                               critic=critic, critic_image_key="T1")
        rec = {"phase": "fit_train", "model": label, "remat": remat,
               "grad_accum_samples": accum}
        try:
            state, _ = step(state, batch, 1e-4, 0.0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch, 1e-4, 0.0)
            torch.cuda.synchronize()
            rec.update(step_ms=(time.perf_counter() - t0) * 1e3,
                       loss_total=float(m["loss_total"]),
                       peak_allocated_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30,
                       peak_reserved_gib=torch.cuda.max_memory_reserved()
                       / 2 ** 30,
                       free_gb=(total - torch.cuda.max_memory_allocated())
                       / 1e9)
        except torch.cuda.OutOfMemoryError as e:
            rec["oom"] = str(e).splitlines()[0][:200]
        del state, step
        torch.cuda.empty_cache()
        rec["fits"] = rec.get("free_gb", 0.0) >= TRAIN_HEADROOM_GB
        print(json.dumps(rec), flush=True)
        if rec["fits"] and chosen is None:
            chosen = (remat, accum)
    return chosen


def fit_variants(dev):
    """fit_train at VARIANT_SETTINGS for each of chip_smoke.VARIANTS and
    the two-stage pair, on a flagship item of its config (160^3 from a
    192^3 bank); prints the chosen (remat, accumulation) of each."""
    chosen = {}
    for name in chip_smoke.VARIANTS + ("twostage",):
        build = build_inpaint_model if name == "twostage" else build_model
        torch.manual_seed(0)
        cfg, model = build(chip_smoke.variant_cfg(name), device=dev)
        _, weight_dict, loss_fn = make_criterion(cfg)
        critic, _ = build_critic_from_cfg(cfg, device=dev)
        scfg = SynthStatic.from_cfg(cfg)
        bank = SubjectBank(chip_smoke.BANK)
        bank.add_debug_subject(seed=0)
        batch = make_batch([torch.Generator(dev).manual_seed(1)],
                           bank.to_device(0, dev), scfg, cfg.tasks, "synth",
                           knobs_from_cfg(cfg, scfg, "synth"))
        settings = [s for s in VARIANT_SETTINGS
                    if scfg.all_samples % s[1] == 0]
        chosen[name] = fit_train(cfg, model, weight_dict, loss_fn, batch, dev,
                                 settings, critic, name)
        del model, critic, batch, bank
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "fit_variants", "chosen": chosen}), flush=True)
    return chosen


def profile_train(dev, out_dir):
    """fit_train, then one profiled step at the chosen setting."""
    cfg = chip_smoke.flagship_cfg()
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank(chip_smoke.BANK)
    bank.add_debug_subject(seed=0)
    batch = make_batch([torch.Generator(dev).manual_seed(1)],
                       bank.to_device(0, dev), scfg, cfg.tasks, "synth",
                       knobs_from_cfg(cfg, scfg, "synth"))
    chosen = fit_train(cfg, model, weight_dict, loss_fn, batch, dev)
    if chosen is None:
        raise RuntimeError("no memory setting fits the flagship train step")
    remat, accum = chosen
    _set_remat(model, remat)
    held = {"state": TrainState(model, build_optimizer(cfg,
                                                       model.parameters()))}
    step = make_train_step(model, cfg, weight_dict, loss_fn,
                           held["state"].optimizer, sample_accum=accum)

    def train_step():
        held["state"], _ = step(held["state"], batch, 1e-4, 0.0)

    train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step()
    torch.cuda.synchronize()
    print(json.dumps({"phase": "train_setting", "remat": remat,
                      "grad_accum_samples": accum}), flush=True)
    breakdown("train_step", train_step, out_dir,
              unprofiled_wall_ms=(time.perf_counter() - t0) * 1e3, top=25)


def profile_serve(cfg, state, dev, out_dir):
    inf = Inferencer(cfg, compute_dtype=torch.bfloat16, exact=False,
                     device=dev)
    inf.model.load_state_dict(state)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.nii")
        save_nifti(path, chip_smoke.procedural_head(
            chip_smoke.SERVE_SHAPE, chip_smoke.SERVE_VOXEL_MM, 10, dev),
            chip_smoke.serve_affine(chip_smoke.SERVE_SHAPE,
                                    chip_smoke.SERVE_VOXEL_MM))

        def serve():
            inf.evaluate_path([path], os.path.join(tmp, "out"),
                              win_size=chip_smoke.SERVE_WIN, prefetch=False,
                              exclude_keys=("segmentation",), ext=".nii")

        serve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        breakdown("serve", serve, out_dir,
                  unprofiled_wall_ms=(time.perf_counter() - t0) * 1e3)
        host_profile("prepare", lambda: prepare_image(
            path, list(chip_smoke.SERVE_WIN), device=dev))


def host_profile(name, fn):
    """cProfile of one call, ended by a synchronize: the top functions
    by their own host time (cProfile's overhead inflates Python-heavy
    functions; the wall is taken around the profiled call)."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:TOP]
    print(json.dumps({"phase": f"host_profile_{name}", "wall_ms": wall_ms,
                      "top": [{"function": f"{os.path.basename(f)}:{line}:"
                               f"{fn_name}", "own_ms": tt * 1e3,
                               "cum_ms": ct * 1e3, "calls": nc}
                              for (f, line, fn_name), (_, nc, tt, ct, _)
                              in rows]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
