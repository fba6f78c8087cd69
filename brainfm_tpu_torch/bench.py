"""The port's benchmark: the stages of the root `bench.py` on one GPU.

    python -m brainfm_tpu_torch.bench                 # every stage, on CUDA
    python -m brainfm_tpu_torch.bench --stages primary,generator
    python -m brainfm_tpu_torch.bench --smoke --device cpu   # tests only

Stages, in the root bench's order, with its shapes and configurations
(`SHAPES`, `INFER_CFG`, `TRAIN_CFG`, `GEN_CFG`, `PATHOL_CFG`) and random
weights from seed 0:

- primary: `Inferencer.evaluate_image(vol, run_postprocess=False,
  keep_feat=False)` of the joint 8-task L6 f_maps-64 model under bf16
  autocast on a 220^3 volume; a second input with one voxel changed must
  give another output.
- train_step: one AdamW step (lr 1e-4, clip 1.0, remat save_convs, bf16)
  at 128^3 on the root bench's random batch; beside it the flagship step
  as the port trains it on one card (cfgs brain_id + joint, 160^3, S=4,
  remat save_convs) on one synthesized batch.
- generator / generator_pathol: `synth_item` at 160^3 (S=2) from a 192^3
  bank with one debug subject of extent 180, one generator per item (seed
  i+1); the second with pathology forced on (random shapes, dopri5
  advection). K1 and K2 run here.
- tiled: `Inferencer.evaluate_tiled` (window 160, stride 80) with bf16
  compute and fp32 accumulation, TF32 off.

Each stage makes one warm-up call (its `*_compile_s`: the kernel builds,
cuDNN's choices, the allocator), then `REPS` timed calls, each ended by a
`torch.cuda.synchronize()`; a timed key holds the median, with `_min` and
`_max` beside it. `cache_cold` is null: nothing here has XLA's cache.

Standard output carries only the contract line, `{"metric", "value",
"unit", "vs_baseline"}`, written after the primary stage and once more
last; file descriptor 1 points at standard error for everything else, from
before torch is imported. The last line of standard error is `# BENCH
SUMMARY {...}`: every key, the card's name and power limit, the launches of
each hand-written kernel per stage, and the stages that failed. A stage
that raises does not stop the later ones, but it is named under `failed`
and the exit code is 1. Without CUDA and without `--device cpu` the bench
exits 2 before any stage.
"""

import os
import sys

if __name__ == "__main__":
    # before torch (or anything that may write to fd 1) is imported
    _REAL_STDOUT = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from brainfm_tpu_torch import kernels  # noqa: E402
from brainfm_tpu_torch.config import AttrDict  # noqa: E402
from brainfm_tpu_torch.device import (card_label, exact_fp32,  # noqa: E402
                                      resolve_device)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the root bench.py's shapes (its VOL, WIN, STRIDE, FM/NL, GSIZE, TSIZE)
SHAPES = {
    "full": {"vol": 220, "win": (160, 160, 160), "stride": (80, 80, 80),
             "f_maps": 64, "num_levels": 6, "gen_size": (160, 160, 160),
             "train_size": (128, 128, 128)},
    "smoke": {"vol": 48, "win": (32, 32, 32), "stride": (16, 16, 16),
              "f_maps": 8, "num_levels": 3, "gen_size": (32, 32, 32),
              "train_size": (32, 32, 32)},
}
# timed calls per stage and timed items per generator stage, after one
# warm-up each; the smoke run is a test of the program, not a measurement
REPS = {"full": {"timed": 5, "items": 8}, "smoke": {"timed": 1, "items": 1}}
STAGES = ("primary", "train_step", "generator", "generator_pathol", "tiled")

# the served model (root bench.py `cfg`); generator.size, f_maps,
# num_levels and task_f_maps come from the shape (`model_cfg`)
INFER_CFG = {
    "task": {"T1": True, "T2": True, "FLAIR": True, "CT": True,
             "segmentation": True, "distance": True, "registration": True,
             "bias_field": True},
    "generator": {"left_hemis_only": False},
    "losses": {"uncertainty": None},
    "backbone": "unet3d", "num_groups": 8, "layer_order": "gcl",
    "unit_feat": False, "max_surf_distance": 3.0,
}
# the trained model (root bench.py `tcfg`), shape keys as above
TRAIN_CFG = {
    "task": {"T1": True, "segmentation": True, "distance": True,
             "registration": True, "bias_field": True},
    "generator": {"left_hemis_only": False},
    "losses": {"uncertainty": None, "image_grad": True,
               "registration_grad": True, "bias_field_log_type": "l2"},
    "weights": {k: 1.0 for k in ("seg_ce", "seg_dice", "image",
                                 "image_grad", "bias_field_log", "distance",
                                 "registration", "registration_grad")},
    "backbone": "unet3d", "num_groups": 8, "layer_order": "gcl",
    "unit_feat": False, "max_surf_distance": 3.0,
    "label_list_segmentation_with_csf": [0, 14, 15, 16, 24, 77, 85],
    "optimizer": "adamw", "lr": 1e-4, "weight_decay": 0.0,
    "clip_max_norm": 1.0, "all_samples": 1, "remat": "save_convs",
}
# the generator stage: bank = 1.2 x the crop, one debug subject of
# extent 1.125 x the crop, SynthStatic(size, all_samples 2, mild 1)
GEN_CFG = {"bank_scale": 1.2, "extent_scale": 1.125, "all_samples": 2,
           "mild_samples": 1, "input_mode": "synth",
           "tasks": ("T1", "segmentation", "distance", "registration",
                     "bias_field")}
# generator_pathol: GEN_CFG with these SynthStatic keys and the task
PATHOL_CFG = {"pathology_prob": 1.0, "random_shape_prob": 1.0,
              "augment_pathology": True, "task": "pathology"}
# the flagship step beside the root bench's: the training CLI's configs
# and chip_smoke.py's memory setting for them
FLAGSHIP = {"gen_cfg": "brain_id", "train_cfg": "joint",
            "remat": "save_convs", "grad_accum_samples": 1}

METRIC = "inference_vols_per_sec_per_chip"
# decimal places of each key, the root bench's `round` (bench.py:91-104,
# :278-512); the flagship step, which the root bench lacks, takes the
# 128^3 step's. `<key>_min` and `<key>_max` take their key's places.
PLACES = {"value": 4, "vs_baseline": 4, "primary_vols_per_sec": 4,
          "whole_volume_ms": 0, "train_step_ms": 0,
          "train_step_flagship_ms": 0, "tiled_fp32_ms": 0,
          "generator_ms_per_item": 1, "generator_pathol_ms_per_item": 1,
          "primary_compile_s": 1, "train_compile_s": 1,
          "train_flagship_compile_s": 1, "generator_compile_s": 1,
          "generator_pathol_compile_s": 1, "tiled_compile_s": 1}


def rounded(key: str, v: float):
    """`v` at the places of `key` (of its base key for `_min`/`_max`), as
    the root bench rounds it: `round(v)`, an int, at 0 places."""
    n = PLACES[re.sub(r"_(min|max)$", "", key)]
    return round(v, n) if n else round(v)
# the root bench's default when BASELINE.json holds no measured line: the
# torch reference L6 flagship, whole volume, on an 8-thread CPU
BASELINE_VOLS_PER_SEC = 0.00086


def model_cfg(base: dict, shape: dict, size) -> AttrDict:
    """`base` with the shape's crop, width and depth."""
    cfg = copy.deepcopy(base)
    cfg["generator"]["size"] = list(size)
    cfg["f_maps"], cfg["num_levels"] = shape["f_maps"], shape["num_levels"]
    cfg["task_f_maps"] = [shape["f_maps"]]
    return AttrDict.from_nested(cfg)


def flagship_cfg(smoke: bool) -> AttrDict:
    """The training CLI's flagship config (FLAGSHIP), processed; the smoke
    shapes cut its width, depth and crop."""
    from brainfm_tpu_torch.models.build import process_args
    from brainfm_tpu_torch.scripts.train import train_config

    cfg = train_config(FLAGSHIP["gen_cfg"], FLAGSHIP["train_cfg"])
    cfg.remat = FLAGSHIP["remat"]
    if smoke:
        shape = SHAPES["smoke"]
        cfg.f_maps, cfg.num_levels = shape["f_maps"], shape["num_levels"]
        cfg.task_f_maps = [shape["f_maps"]]
        cfg.generator.size = list(shape["gen_size"])
    return process_args(cfg)


def baseline_vols_per_sec() -> float:
    """BASELINE.json's measured whole-volume line, as the root bench reads
    it, else BASELINE_VOLS_PER_SEC."""
    try:
        with open(os.path.join(ROOT, "BASELINE.json")) as f:
            bl = json.load(f)
        return float((bl.get("measured", {}) or {}).get(
            "whole_volume_inference_vols_per_sec") or BASELINE_VOLS_PER_SEC)
    except (OSError, ValueError, AttributeError):
        return BASELINE_VOLS_PER_SEC


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


class Bench:
    """One run: the device, the shapes, the summary being filled and the
    contract lines written."""

    def __init__(self, device, smoke: bool, out_fd: int):
        self.dev = device
        self.size = "smoke" if smoke else "full"
        self.shape = SHAPES[self.size]
        self.reps = REPS[self.size]
        self.out_fd = out_fd
        self.card = card_label(device)
        self.summary = {"cache_cold": None, "device": self.card,
                        "launches": {}, "failed": []}
        self.contract = None
        self.vol = None

    # ------------------------------------------------------------ timing

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call_ms(self, fn):
        """fn() timed on the host clock between two synchronizes."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return (time.perf_counter() - t0) * 1e3

    def record(self, key, times):
        """The median of `times` (ms) under `key`, its spread beside it,
        each at the key's places; returns the median unrounded."""
        med = statistics.median(times)
        for k, v in ((key, med), (f"{key}_min", min(times)),
                     (f"{key}_max", max(times))):
            self.summary[k] = rounded(k, v)
        return med

    def timed(self, stage, key, fns):
        """Each of `fns` timed in turn with the kernel launches counted
        over them; the median and spread go under `key`."""
        kernels.reset_launches()
        times = [self.call_ms(fn) for fn in fns]
        self.summary["launches"].setdefault(stage, {})[key] = {
            "calls": len(times), **kernels.LAUNCHES}
        return times, self.record(key, times)

    def warm(self, key, fn):
        self.summary[key] = rounded(key, self.call_ms(fn) / 1e3)

    # ------------------------------------------------------------ stages

    def volume(self):
        if self.vol is None:
            v = np.random.default_rng(0).random((self.shape["vol"],) * 3)
            self.vol = torch.from_numpy(v).float().to(self.dev)
        return self.vol

    def inferencer(self):
        from brainfm_tpu_torch.infer import Inferencer

        cfg = model_cfg(INFER_CFG, self.shape, self.shape["win"])
        return Inferencer(cfg, ckpt_path=None, compute_dtype=torch.bfloat16,
                          exact=False, device=self.dev)

    def emit_contract(self, vols_per_sec):
        baseline = baseline_vols_per_sec()
        s = self.shape
        line = json.dumps({
            "metric": METRIC, "value": rounded("value", vols_per_sec),
            "unit": f"volumes/s ({s['vol']}^3 whole-volume single-pass "
                    f"forward, joint 8-task UNet3D f{s['f_maps']} "
                    f"L{s['num_levels']} bf16, random weights; on "
                    f"{self.card}; vs_baseline = ratio to the torch "
                    f"reference L6 flagship whole-volume on an 8-thread "
                    f"CPU, {baseline} vol/s, BASELINE.md)",
            "vs_baseline": rounded("vs_baseline", vols_per_sec / baseline)})
        self.contract = line
        os.write(self.out_fd, (line + "\n").encode())
        self.summary["vs_baseline"] = rounded("vs_baseline",
                                              vols_per_sec / baseline)

    def stage_primary(self):
        inf = self.inferencer()
        vol = self.volume()

        def run(v):
            return inf.evaluate_image(v, run_postprocess=False,
                                      keep_feat=False)

        out = {}
        self.warm("primary_compile_s", lambda: out.update(run(vol)))
        # a second input with one voxel changed must give another output:
        # the timed calls compute on their input
        vol2 = vol.clone()
        vol2[0, 0, 0] += 0.5
        t1, t2 = out["T1"], run(vol2)["T1"]
        if torch.allclose(t1, t2):
            raise AssertionError("a changed input gave the same output")
        del out, t1, t2, vol2
        times, ms = self.timed("primary", "whole_volume_ms",
                               [lambda: run(vol)] * self.reps["timed"])
        for k, v in (("primary_vols_per_sec", 1e3 / ms),
                     ("primary_vols_per_sec_min", 1e3 / max(times)),
                     ("primary_vols_per_sec_max", 1e3 / min(times))):
            self.summary[k] = rounded(k, v)
        self.emit_contract(1e3 / ms)
        log(f"whole volume: {self.summary['whole_volume_ms']:.1f} ms "
            f"(median of {len(times)}) / {self.shape['vol']}^3, bf16")

    def _step_stage(self, cfg, batch, key, compile_key, sample_accum=1):
        from brainfm_tpu_torch.models import build_model
        from brainfm_tpu_torch.models.criterion import make_criterion
        from brainfm_tpu_torch.train.step import (TrainState,
                                                  build_optimizer,
                                                  make_train_step)

        torch.manual_seed(0)
        cfg, model = build_model(cfg, device=self.dev)
        _, weights, loss_fn = make_criterion(cfg)
        opt = build_optimizer(cfg, model.parameters())
        step = make_train_step(model, cfg, weights, loss_fn, opt,
                               sample_accum=sample_accum, amp=True)
        state = TrainState(model, opt, 0)
        lr, wd = float(cfg.lr), float(cfg.weight_decay or 0.0)
        metrics = []

        def run():
            metrics.append(step(state, batch, lr, wd)[1])

        self.warm(compile_key, run)
        self.timed("train_step", key, [run] * self.reps["timed"])
        bad = [float(m["loss_total"]) for m in metrics
               if not math.isfinite(float(m["loss_total"]))
               or float(m["skipped"])]
        if bad:
            raise AssertionError(f"{key}: non-finite or skipped steps {bad}")

    def root_train_batch(self):
        """The root bench's random batch (its default_rng(1) draws, in its
        order), on the device."""
        ts = self.shape["train_size"]
        rng = np.random.default_rng(1)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.dev)

        x = dev(rng.random((1, *ts, 1)))
        t1 = dev(rng.random((1, 1, *ts, 1)))
        seg = torch.from_numpy(rng.integers(0, 56, (1, 1, *ts))).to(self.dev)
        return {"samples": {"input": x[None],
                            "bias_field_log": torch.zeros_like(x)[None]},
                "targets": {"T1": t1,
                            "segmentation": F.one_hot(seg, 56).float(),
                            "distance": dev(rng.random((1, 1, *ts, 4))),
                            "registration": dev(rng.random((1, 1, *ts,
                                                            3)))}}

    def flagship(self):
        """The flagship config and one synthesized batch."""
        from brainfm_tpu_torch.synth import SynthStatic, knobs_from_cfg
        from brainfm_tpu_torch.train.loop import make_batch

        cfg = flagship_cfg(self.size == "smoke")
        scfg = SynthStatic.from_cfg(cfg)
        subj = self.subject(scfg.size)
        gen = torch.Generator(self.dev).manual_seed(0)
        batch = make_batch([gen], subj, scfg, cfg.tasks, "synth",
                           knobs_from_cfg(cfg, scfg, "synth"))
        return cfg, batch

    def stage_train_step(self):
        self._step_stage(model_cfg(TRAIN_CFG, self.shape,
                                   self.shape["train_size"]),
                         self.root_train_batch(), "train_step_ms",
                         "train_compile_s")
        gc.collect()
        self.empty_cache()
        cfg, batch = self.flagship()
        self._step_stage(cfg, batch, "train_step_flagship_ms",
                         "train_flagship_compile_s",
                         sample_accum=FLAGSHIP["grad_accum_samples"])
        log(f"train step: {self.summary['train_step_ms']:.1f} ms at "
            f"{self.shape['train_size'][0]}^3; flagship "
            f"{self.summary['train_step_flagship_ms']:.1f} ms")

    def subject(self, size):
        from brainfm_tpu_torch.synth import SubjectBank

        bank = SubjectBank(tuple(int(s * GEN_CFG["bank_scale"])
                                 for s in size))
        bank.add_debug_subject(seed=0, extent=tuple(
            int(s * GEN_CFG["extent_scale"]) for s in size))
        return bank.to_device(0, self.dev)

    def _generator_stage(self, stage, key, compile_key, pathology):
        from brainfm_tpu_torch.synth import SynthStatic, synth_item
        from brainfm_tpu_torch.synth.engine import build_knobs_stack

        size = self.shape["gen_size"]
        extra = ({k: v for k, v in PATHOL_CFG.items() if k != "task"}
                 if pathology else {})
        scfg = SynthStatic(size=size, all_samples=GEN_CFG["all_samples"],
                           mild_samples=GEN_CFG["mild_samples"], **extra)
        tasks = GEN_CFG["tasks"] + ((PATHOL_CFG["task"],) if pathology
                                    else ())
        mode = GEN_CFG["input_mode"]
        knobs = build_knobs_stack(scfg, mode)
        subj = self.subject(size)
        shapes = []

        def item(seed):
            def run():
                gen = torch.Generator(self.dev).manual_seed(seed)
                target, samples = synth_item(gen, subj, scfg, tasks, mode,
                                             knobs)
                shapes.append(tuple(samples["input"].shape))
                if not bool(torch.isfinite(samples["input"]).all()):
                    raise AssertionError(f"{stage}: non-finite input "
                                         f"(seed {seed})")
            return run

        self.warm(compile_key, item(0))
        self.timed(stage, key, [item(i + 1)
                                for i in range(self.reps["items"])])
        want = (GEN_CFG["all_samples"], *size, 1)
        if any(s != want for s in shapes):
            raise AssertionError(f"{stage}: input shapes {set(shapes)}")
        log(f"{stage}: {self.summary[key]:.1f} ms/item at {size[0]}^3")

    def stage_generator(self):
        self._generator_stage("generator", "generator_ms_per_item",
                              "generator_compile_s", False)

    def stage_generator_pathol(self):
        self._generator_stage("generator_pathol",
                              "generator_pathol_ms_per_item",
                              "generator_pathol_compile_s", True)

    def stage_tiled(self):
        inf = self.inferencer()
        vol = self.volume()
        s = self.shape

        def run():
            with exact_fp32():
                out = inf.evaluate_tiled(vol, stride=s["stride"],
                                         win_size=s["win"],
                                         run_postprocess=False,
                                         accum_dtype=torch.float32)
            bad = [k for k, v in out.items()
                   if v.dtype != torch.float32 or tuple(v.shape[:3])
                   != (s["vol"],) * 3 or not bool(torch.isfinite(v).all())]
            if bad:
                raise AssertionError(f"tiled outputs {bad}")

        self.warm("tiled_compile_s", run)
        self.timed("tiled", "tiled_fp32_ms", [run] * self.reps["timed"])
        log(f"tiled (fp32 blend): {self.summary['tiled_fp32_ms']:.1f} ms / "
            f"{s['vol']}^3, window {s['win'][0]}, stride {s['stride'][0]}")

    # -------------------------------------------------------------- run

    def empty_cache(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def run(self, stages):
        for name in stages:
            log(f"stage {name}")
            t0 = time.perf_counter()
            try:
                getattr(self, f"stage_{name}")()
            except Exception:
                traceback.print_exc(file=sys.stderr)
                self.summary["failed"].append(name)
            log(f"stage {name}: {time.perf_counter() - t0:.1f} s")
            gc.collect()
            self.empty_cache()

    def finish(self) -> int:
        """The contract line again, last on stdout; the summary last on
        stderr. 0 when no stage failed."""
        if self.contract is not None:
            os.write(self.out_fd, (self.contract + "\n").encode())
        print(f"# BENCH SUMMARY {json.dumps(self.summary)}", file=sys.stderr,
              flush=True)
        return 1 if self.summary["failed"] else 0


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the plain versions")
    ap.add_argument("--smoke", action="store_true",
                    help="the root bench's smoke shapes (tests only)")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"comma-separated subset of {','.join(STAGES)}")
    return ap


def main(argv=None, out_fd=None) -> int:
    args = build_parser().parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        log(f"unknown stages {unknown}: {','.join(STAGES)}")
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        log(f"FATAL: {e}")
        return 2
    bench = Bench(dev, args.smoke, out_fd if out_fd is not None else 1)
    log(f"device {bench.card}, {bench.size} shapes, stages {stages}")
    t0 = time.perf_counter()
    bench.run([s for s in STAGES if s in stages])
    log(f"bench complete in {time.perf_counter() - t0:.1f} s")
    return bench.finish()


if __name__ == "__main__":
    rc = 1
    try:
        rc = main(out_fd=_REAL_STDOUT)
    finally:
        sys.stderr.flush()
    sys.exit(rc)
