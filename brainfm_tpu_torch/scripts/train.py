"""Training entry point of the PyTorch port (twin of scripts/train.py, the
JAX package's):

    python -m brainfm_tpu_torch.scripts.train [--gen_cfg brain_id]
        [--train_cfg joint] [--out_dir DIR] [--epochs N]
        [--itr_per_epoch N] [--resume CKPT_DIR] [--debug]
        [--remat off|full|save_convs] [--no_amp] [--grad_accum K]
        [--staging cache|host] [--batch_items B] [--device cpu]

Cascading config load, model and criterion build, the subject bank, then
train/loop.py::train. Runs on CUDA unless --device says otherwise. The bank
holds procedural debug subjects; a data root that holds subject files
raises, since loading them is not ported yet (ROADMAP Queue 1 item 4:
SubjectBank.add_many, synth/datasets.py). So do --mesh, --fsdp and
--eval_only, which need the multi-GPU slice or the dataset stream.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch

from ..config import load_config, merge_missing
from ..models.build import build_model
from ..models.criterion import make_criterion
from ..synth.engine import SubjectBank
from ..train.loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_bank(cfg, bank_shape=(192, 192, 192), extent=(180, 180, 180)):
    """The subject bank: procedural debug subjects (4, of `extent`) when
    the configured data root holds no subject files. Subject files raise:
    reading them is not ported yet."""
    root = cfg.data_root or ""
    if root and glob.glob(os.path.join(root, "*T1w.nii*")):
        raise NotImplementedError(
            f"{root} holds subject files; loading them (SubjectBank.add_many, "
            "synth/datasets.py) is not ported yet (ROADMAP Queue 1 item 4)")
    print("NOTE: no dataset found under", root,
          "- using procedural debug subjects")
    bank = SubjectBank(bank_shape=bank_shape)
    for s in range(4):
        bank.add_debug_subject(seed=s, extent=extent)
    return bank


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
    ap.add_argument("--eval_only", action="store_true")
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
    for flag, what in ((args.mesh, "--mesh"), (args.fsdp, "--fsdp"),
                       (args.eval_only, "--eval_only")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet (the multi-GPU slice and the "
                "dataset stream, ROADMAP Queue 1 items 4 and 6)")

    gen_cfg = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                           args.gen_cfg],
                          cfg_dir=os.path.join(ROOT, "cfgs/generator/train"))
    train_cfg = load_config(
        [os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
         args.train_cfg], cfg_dir=os.path.join(ROOT, "cfgs/trainer/train"))
    merge_missing(train_cfg, gen_cfg)
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
    if train_cfg.get("eval_only"):
        raise NotImplementedError("eval_only is not ported yet (the dataset "
                                  "stream, ROADMAP Queue 1 item 4)")
    if "+" in str(train_cfg.get("backbone") or ""):
        raise NotImplementedError("two-stage backbones are not ported yet "
                                  "(ROADMAP Queue 1 item 6)")

    torch.manual_seed(0)
    cfg, model = build_model(train_cfg, device=args.device)
    _, weight_dict, loss_fn = make_criterion(cfg)
    # a timestamped run directory under outs/, as the JAX script's
    out_dir = args.out_dir or os.path.join(
        "outs", f"{cfg.job_name or 'job'}-{cfg.exp_name or 'exp'}-"
        f"{time.strftime('%Y%m%d-%H%M%S')}")
    bank = build_bank(cfg)
    itr = 2 if args.debug else args.itr_per_epoch
    batch_items = args.batch_items or int(cfg.get("batch_size") or 1)
    state = train(cfg, model, weight_dict, loss_fn, bank, out_dir,
                  itr_per_epoch=itr, resume=args.resume,
                  batch_items=batch_items)
    print("training done; final step", state.step)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        print(f"device memory peak: "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
