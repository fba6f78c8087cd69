"""The readings the output check's limits are set from, at a cell's own
size on the card (not part of the benchmark's runs).

    python3 -m brainbench.control --workload joint.train \\
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed of `--seeds` the program's side as a run makes it (training:
the first steps of the training object; serving: `--requests` requests
through evaluate_path) against the plain reference: the lower readings.
For each seed of `--control-seeds` the control, the reference in the
precision below the configuration's put in the program's place (every
convolution's operands rounded to float8 e4m3; the synthesized batch and
the prepared volume, float32 in the program, rounded to bfloat16), and, for training, a planted fault (the second half
of each item's samples left out, the mean over the rest): the upper
readings. One JSON line per seed and side on standard output.

A training cell (a traffic with a subject bank) is read with its driver
module's parts, `PROGRAM` and `REFERENCE` (drivers/train.py), so a cell
whose driver brings its own model and reference needs no copy of this
file.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import tempfile
import time

import torch

from . import cells, check, run as brun
from .drivers import serve as sv
from .drivers import train as tr


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _bf16(batch):
    return {part: {k: (v.to(torch.bfloat16).to(v.dtype)
                       if v.is_floating_point() else v)
                   for k, v in batch[part].items()}
            for part in ("samples", "targets")}


def train_readings(cell, seed, dev, control):
    traffic, cfg_tree = cell.traffic, cell.config["cfg"]
    driver = importlib.import_module(
        f"brainbench.drivers.{traffic['driver']}")
    subjects = tr.make_subjects(traffic, seed, dev)
    order = tr.subject_order(seed, len(subjects), tr.CHECK_STEPS)
    out = []
    t = time.perf_counter()
    prog = driver.PROGRAM(cfg_tree, traffic, seed, dev, subjects)
    parts = {"reference": driver.REFERENCE, "items": prog.batch_items}
    prog_rec, batches, _, _ = tr.first_steps(prog, order, seed)
    prog.free()
    del prog
    _free()
    ref, gaps = tr.reference_steps(cfg_tree, traffic, seed, dev, subjects,
                                   order, prog_batches=batches, **parts)
    out.append({"side": "program", "s": time.perf_counter() - t,
                "losses": prog_rec.losses, "ref_losses": ref.losses,
                **check.train_checks(prog_rec, ref, gaps)})
    if control:
        t = time.perf_counter()
        ctl, _ = tr.reference_steps(cfg_tree, traffic, seed, dev, subjects,
                                    order, quant="fp8", **parts)
        bgap = [check.batch_gap(_bf16(b), b) for b in batches]
        out.append({"side": "control", "s": time.perf_counter() - t,
                    **check.train_checks(ctl, ref, bgap)})
        S = int(cfg_tree["generator"]["all_samples"])
        t = time.perf_counter()
        half, _ = tr.reference_steps(cfg_tree, traffic, seed, dev, subjects,
                                     order, samples=max(1, S // 2), **parts)
        out.append({"side": "half_batch", "s": time.perf_counter() - t,
                    **check.train_checks(half, ref, [0.0])})
    return out


def serve_readings(cell, seed, dev, control, requests):
    traffic, cfg_tree = cell.traffic, cell.config["cfg"]
    win = tuple(int(w) for w in traffic["win"])
    work = tempfile.mkdtemp(prefix="brainbench-control-")
    out = []
    try:
        paths = sv.make_inputs(traffic, seed, dev, work)[:requests]
        t = time.perf_counter()
        inf = sv._inferencer(cfg_tree, seed, dev)
        kept = []
        for k, p in enumerate(paths):
            save = os.path.join(work, f"r{k}")
            inf.begin(True)
            inf.evaluate_path([p], save, win_size=win,
                              exclude_keys=sv._AllBut(traffic["write"]),
                              ext=".nii.gz")
            kept.append(dict(inf.keep, save=save, path=p))
        del inf
        _free()
        from .reference.utils.nifti import load_nifti

        ref_cfg, ref_model = sv.reference(cfg_tree, seed, dev)
        refs, rows, paths = [], [], [r["path"] for r in kept]
        for rec in kept:
            written = load_nifti(sv.label_file(rec["save"], rec["path"]))[0]
            im, ro = sv.reference_outputs(ref_cfg, ref_model, rec["path"], win)
            rows.append(sv.compare(rec["prepared"], rec["outs"], written, im,
                                   ro))
            refs.append((im, ro))
        kept.clear()
        _free()
        out.append({"side": "program", "s": time.perf_counter() - t,
                    "per_request": rows, **check.serve_checks(rows)})
        if control:
            t = time.perf_counter()
            del ref_model
            _free()
            q_cfg, q_model = sv.reference(cfg_tree, seed, dev, quant="fp8")
            rows = []
            for (im, ro), p in zip(refs, paths):
                qim, qo = sv.reference_outputs(q_cfg, q_model, p, win)
                rows.append(sv.compare(qim.to(torch.bfloat16).float(), qo,
                                       qo["label"].cpu().numpy(), im, ro))
            out.append({"side": "control", "s": time.perf_counter() - t,
                        "per_request": rows, **check.serve_checks(rows)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def readings(cell, seed, dev, control, requests):
    """One seed's rows: a training cell's by `train_readings`, a serving
    cell's by `serve_readings`."""
    if cells.is_training(cell.traffic):
        return train_readings(cell, seed, dev, control)
    return serve_readings(cell, seed, dev, control, requests)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    brun.set_cache_dirs()
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card")
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        rows = readings(cell, seed, dev, seed in ctl, args.requests)
        for r in rows:
            print(json.dumps({"cell": cell.name, "seed": seed, **r}),
                  flush=True)
        _free()


if __name__ == "__main__":
    main()
