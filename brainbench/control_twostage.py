"""The readings the two-stage serving cell's limits are set from, at the
cell's own size on the card (not part of the benchmark's runs); control.py
takes the other cells'.

    python3 -m brainbench.control_twostage --workload twostage.serve \\
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed of `--seeds`, `--requests` requests through the program's
TwoStageInferencer.evaluate_path against the plain two-stage reference
(drivers/serve_twostage.py): the lower readings. For each seed of
`--control-seeds` the control, the reference in the precision below the
configuration's put in the program's place (every convolution's operands
of both stages rounded to float8 e4m3; the prepared volume, float32 in
the program, rounded to bfloat16): the upper readings. One JSON line per
seed and side on standard output, with each request's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from . import cells, check, run as brun
from .control import _free
from .drivers import serve_twostage as st


def readings(cell, seed, dev, control, requests):
    traffic, cfg_tree = cell.traffic, cell.config["cfg"]
    win = tuple(int(w) for w in traffic["win"])
    work = tempfile.mkdtemp(prefix="brainbench-control-twostage-")
    out = []
    try:
        paths = st.make_inputs(traffic, seed, dev, work)[:requests]
        t = time.perf_counter()
        inf = st._inferencer(cfg_tree, seed, dev)
        kept = []
        for k, p in enumerate(paths):
            save = os.path.join(work, f"r{k}")
            inf.begin(True)
            inf.evaluate_path([p], save, win_size=win,
                              exclude_keys=st._AllBut(traffic["write"]),
                              ext=".nii.gz")
            kept.append(dict(inf.keep, save=save, path=p))
        del inf
        _free()
        from .reference.utils.nifti import load_nifti

        ref_cfg, ref_model = st.reference(cfg_tree, seed, dev)
        refs, rows, paths = [], [], [r["path"] for r in kept]
        for rec in kept:
            written = load_nifti(st.label_file(rec["save"], rec["path"]))[0]
            im, ro = st.reference_outputs(ref_cfg, ref_model, rec["path"],
                                          win)
            rows.append(st.compare(rec["prepared"], rec["outs"], written, im,
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
            q_cfg, q_model = st.reference(cfg_tree, seed, dev, quant="fp8")
            rows = []
            for (im, ro), p in zip(refs, paths):
                qim, qo = st.reference_outputs(q_cfg, q_model, p, win)
                rows.append(st.compare(qim.to(torch.bfloat16).float(), qo,
                                       qo["label"].cpu().numpy(), im, ro))
            out.append({"side": "control", "s": time.perf_counter() - t,
                        "per_request": rows, **check.serve_checks(rows)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="twostage.serve")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    brun.set_cache_dirs()
    cell = cells.load(args.workload)
    if cell.traffic["driver"] != "serve_twostage":
        raise SystemExit(f"{cell.name} is not a two-stage serving cell")
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card")
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        for r in readings(cell, seed, dev, seed in ctl, args.requests):
            print(json.dumps({"cell": cell.name, "seed": seed, **r}),
                  flush=True)
        _free()


if __name__ == "__main__":
    main()
