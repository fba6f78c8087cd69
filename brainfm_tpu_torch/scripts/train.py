"""Training entry point of the PyTorch port (twin of scripts/train.py, the
JAX package's):

    python -m brainfm_tpu_torch.scripts.train [--gen_cfg brain_id]
        [--train_cfg joint] [--out_dir DIR] [--epochs N]
        [--itr_per_epoch N] [--resume CKPT_DIR] [--debug]
        [--remat off|full|save_convs] [--no_amp] [--grad_accum K]
        [--staging cache|host] [--batch_items B] [--device cpu]
        [--eval_only --resume CKPT_DIR]

Cascading config load, model and criterion build, then the datasets of
synth/datasets.py::build_datasets (every dataset named by the generator
config's dataset_names, all eight when it is empty) and
train/loop.py::train on their stream. Subjects are read from the config's
data_root in the DATASET_SETUPS layout (<data_root>/<dataset root>/
label_maps_generation, T1, T2, ... ; the stroke datasets'
pathology_probs), the subjects of each dataset listed in
<split_root>/<split>.txt; without a data root on disk each dataset holds
one procedural debug subject. --eval_only --resume CKPT_DIR scores the
fixed-seed stream validation set with the checkpoint's weights instead of
training (with the frozen critic when losses.implicit_pathol is on). An
'a+b' backbone (twostage.yaml) trains the two-stage pair of
models/build.py::build_inpaint_model; --eval_only refuses it, as the JAX
script does (infer/api.py::TwoStageInferencer serves it). Runs on CUDA
unless --device says otherwise. --mesh and --fsdp (the multi-GPU slice,
ROADMAP Queue 1 item 5) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch

from ..config import load_config, merge_missing
from ..infer.api import Inferencer
from ..models.build import (build_critic_from_cfg, build_inpaint_model,
                            build_model)
from ..models.criterion import make_criterion
from ..synth.datasets import build_datasets
from ..synth.engine import SubjectBank
from ..train.loop import make_eval_step, make_val_set_stream, train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_bank(cfg, bank_shape=(192, 192, 192), extent=(180, 180, 180)):
    """A subject bank from the flat layout of a data root: `<id>.T1w.nii*`
    with `<id>.generation_labels`, `<id>.<segment_prefix>`, the four
    `<id>.{lp,lw,rp,rw}_dist_map` and three `<id>.mni_reg.{x,y,z}`
    companions (.nii or .nii.gz), read in one codec batch
    (SubjectBank.add_many); a T1 without generation labels is skipped.
    Without subjects, 4 procedural debug subjects of `extent`."""
    bank = SubjectBank(bank_shape=bank_shape)
    root = cfg.data_root or ""
    t1s = sorted(glob.glob(os.path.join(root, "*T1w.nii*"))) if root else []

    def find(base, suffix):
        for ext in (".nii", ".nii.gz"):
            p = base + suffix + ext
            if os.path.isfile(p):
                return p
        return None

    subj_paths = []
    for t1 in t1s:
        base = t1.split(".T1w.nii")[0]
        paths = {"T1": t1}
        gen = find(base, ".generation_labels")
        if not gen:
            print("skipping (no generation labels):", t1)
            continue
        paths["gen"] = gen
        seg = find(base, f".{cfg.segment_prefix}")
        if seg:
            paths["seg"] = seg
        dist = [find(base, f".{k}_dist_map") for k in ("lp", "lw", "rp", "rw")]
        if all(dist):
            paths["dist"] = dist
        reg = [find(base, f".mni_reg.{a}") for a in ("x", "y", "z")]
        if all(reg):
            paths["reg"] = reg
        subj_paths.append(paths)
    if subj_paths:
        bank.add_many(subj_paths)
    if len(bank) == 0:
        print("NOTE: no dataset found under", root,
              "- using procedural debug subjects")
        for s in range(4):
            bank.add_debug_subject(seed=s, extent=extent)
    return bank


def train_config(gen_cfg=None, train_cfg=None):
    """The trainer config as the CLI loads it: cfgs/generator/default.yaml
    under `gen_cfg` (a name in cfgs/generator/train or a YAML path),
    cfgs/trainer/default_train.yaml under `train_cfg`, the generator tree
    merged into the trainer's where it has no value."""
    gen = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                       gen_cfg],
                      cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    tr = load_config([os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                      train_cfg],
                     cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    return merge_missing(tr, gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gen_cfg", default=None)
    ap.add_argument("--train_cfg", default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--itr_per_epoch", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--debug", action="store_true",
                    help="one epoch of 2 iterations")
    ap.add_argument("--eval_only", action="store_true",
                    help="score the stream's validation set with the "
                         "--resume checkpoint's weights; no training")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--batch_items", type=int, default=0,
                    help="items per step (0 = cfg.batch_size)")
    ap.add_argument("--remat", default=None,
                    choices=["off", "full", "save_convs"],
                    help="override cfg.remat")
    ap.add_argument("--no_amp", action="store_true",
                    help="fp32 compute (default: bf16 autocast around the "
                         "model, fp32 params, gradients and optimizer state)")
    ap.add_argument("--staging", default=None, choices=["cache", "host"],
                    help="override cfg.subject_staging: 'host' ships each "
                         "drawn subject uncached")
    ap.add_argument("--grad_accum", type=int, default=None, metavar="K",
                    help="override cfg.grad_accum_samples: the sample stack "
                         "in K sequential microbatches (exact); K divides "
                         "all_samples")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    for flag, what in ((args.mesh, "--mesh"), (args.fsdp, "--fsdp")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet (the multi-GPU slice, ROADMAP "
                "Queue 1 item 5)")

    train_cfg = train_config(args.gen_cfg, args.train_cfg)
    if args.remat is not None:
        train_cfg.remat = {"off": False, "full": True,
                           "save_convs": "save_convs"}[args.remat]
    if args.staging is not None:
        train_cfg.subject_staging = args.staging
    if args.grad_accum is not None:
        train_cfg.grad_accum_samples = args.grad_accum
    if args.epochs is not None:
        train_cfg.n_epochs = args.epochs
    if args.debug:
        train_cfg.n_epochs = 1
    if args.no_amp:
        train_cfg.amp = False

    torch.manual_seed(0)
    # an 'a+b' backbone (twostage.yaml) trains two-stage: the stage-0
    # pathology predictor, then the masked, mask-conditioned task model
    twostage = "+" in str(train_cfg.get("backbone") or "")
    if twostage:
        cfg, model = build_inpaint_model(train_cfg, device=args.device)
    else:
        cfg, model = build_model(train_cfg, device=args.device)
    _, weight_dict, loss_fn = make_criterion(cfg)
    # a timestamped run directory under outs/, as the JAX script's
    out_dir = args.out_dir or os.path.join(
        "outs", f"{cfg.job_name or 'job'}-{cfg.exp_name or 'exp'}-"
        f"{time.strftime('%Y%m%d-%H%M%S')}")
    dev = next(model.parameters()).device
    t0 = time.perf_counter()
    datasets = build_datasets(cfg, cfg.tasks, device=dev)
    stream = datasets["_concat"]
    print("datasets:", {n: len(d) for n, d in datasets.items()
                        if n != "_concat"},
          f"(ingest {time.perf_counter() - t0:.3f} s)")
    itr = 2 if args.debug else args.itr_per_epoch
    batch_items = args.batch_items or int(cfg.get("batch_size") or 1)
    if (args.eval_only or cfg.get("eval_only")) and twostage:
        ap.error("--eval_only is not wired for two-stage configs: use "
                 "infer.api.TwoStageInferencer")
    if args.eval_only or cfg.get("eval_only"):
        if not args.resume:
            ap.error("--eval_only requires --resume <checkpoint>: scoring "
                     "a randomly initialized model would print plausible-"
                     "looking val losses of untrained weights")
        # the seed, n_items and batch_items of train()'s stream validation,
        # so the scores compare with the checkpoint's best_val_stats
        vb, vnames = make_val_set_stream(stream, seed=0, n_items=2,
                                         batch_items=batch_items)
        print("val set spans datasets:", sorted(set(vnames)))
        inf = Inferencer(cfg, ckpt_path=args.resume, device=dev)
        # train()'s critic, so the scores compare with best_val_stats
        critic, ckey = build_critic_from_cfg(cfg, device=dev)
        ev = make_eval_step(inf.model, cfg, weight_dict, loss_fn,
                            critic=critic, critic_image_key=ckey)
        for i, b in enumerate(vb):
            losses = ev(inf.model, b)
            print(f"val[{i}]:",
                  {k: round(float(v), 4) for k, v in losses.items()})
        return 0
    state = train(cfg, model, weight_dict, loss_fn, None, out_dir,
                  itr_per_epoch=itr, resume=args.resume, stream=stream,
                  batch_items=batch_items,
                  twostage_models=model if twostage else None)
    print("training done; final step", state.step)
    if dev.type == "cuda":
        print(f"device memory peak: "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
