"""Batch evaluation on the PyTorch port (twin of scripts/test.py, the JAX
package's):

    python -m brainfm_tpu_torch.scripts.test --input_glob 'data/*.nii.gz'
        [--models joint=ckp/model.pth ...] [--spacings native 1.5,1.5,5]
        [--add_bf] [--hemis_seg_suffix .seg.nii.gz] [--atlas MNI.mgz]
        [--save_dir outs/test] [--bf16] [--device cpu]
    python -m brainfm_tpu_torch.scripts.test --pred_glob 'outs/test/*/*/out_T1.nii.gz'
        --gt_suffix .gt.nii.gz --metrics recon_psnr recon_ssim [--is_seg]

Serves every input under every model and setup (the acquisition spacing,
with or without a synthetic bias field) into
<save_dir>/<postfix>[_BF]_<spacing or 1-1-1>/<subject>/out_<key>.nii.gz,
with the hemisphere mask and the deformed atlas where their inputs exist;
then scores prediction files against ground truth with
models/evaluator.py::Evaluator.eval_files and writes
<save_dir>/scores.json with the per-case scores and their means. Runs on
CUDA unless --device says otherwise. --bf16 serves under bf16 autocast;
the default is fp32 with TF32 off, the JAX twin's precision.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import load_config
from ..device import resolve_device
from ..infer.api import Inferencer, default_atlas_path, get_deformed_atlas
from ..infer.prepare import prepare_image
from ..models.evaluator import Evaluator, hemis_mask_from, path_stem
from ..utils.nifti import save_nifti

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_setups(spacings, add_bf_opts):
    """The (spacing or None, add_bf) grid of scripts/test.py:129-141."""
    out = []
    for sp in spacings:
        for bf in add_bf_opts:
            out.append((None if sp == "native" else
                        [float(v) for v in sp.split(",")], bf))
    return out


def setup_tag(postfix, spacing, add_bf):
    """<postfix>[_BF]_<spacing joined by '-' or 1-1-1>."""
    tag = postfix + ("_BF" if add_bf else "")
    return tag + "_" + ("-".join(str(s) for s in spacing)
                        if spacing else "1-1-1")


def _models(args):
    for m in args.models:
        if "=" not in m:
            raise SystemExit(
                f"--models entry {m!r} must be <postfix>=<ckpt_path> "
                "(e.g. joint=ckp/brainfm_pretrained.pth)")
    if args.models and args.ckp_path:
        print("note: --models given; ignoring --ckp_path")
    return [tuple(m.split("=", 1)) for m in args.models] or \
        [("default", args.ckp_path)]


def _hemis_mask(args, path, dev):
    """The hemisphere mask of one input from its label map and MNI-x files
    (<stem><suffix>), or None when either is missing."""
    if not args.hemis_seg_suffix:
        return None
    stem = path_stem(path)
    seg_p = stem + args.hemis_seg_suffix
    regx_p = stem + args.hemis_regx_suffix
    if not (os.path.isfile(seg_p) and os.path.isfile(regx_p)):
        return None
    seg, _, _, _ = prepare_image(seg_p, list(args.win), is_label=True,
                                 rescale=False, device=dev)
    rx, _, _, _ = prepare_image(regx_p, list(args.win), rescale=False,
                                device=dev)
    return hemis_mask_from(seg, rx)


def run_inference_cases(args, cfg, setups, device=None, stats=None):
    """Every model x setup x input: prepare, serve, write (parity:
    scripts/test.py:152-226). `stats`, when given, receives per setup tag
    the per-volume stage times in ms: `prepare_ms` (the image and the
    hemisphere mask), `forward_ms` (the model, postprocess, the atlas and
    the copy to the host), `write_ms` (the .nii.gz files, on 4 threads)
    and `volume_ms`, their sum; with `stats` each stage ends in a device
    synchronize."""
    dev = resolve_device(device)
    models = _models(args)
    paths = sorted(glob.glob(args.input_glob))
    print(f"{len(paths)} inputs; {len(models)} models; {len(setups)} setups")

    def clock():
        """The stage clock: only when timing, after a device synchronize."""
        if stats is None:
            return 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    for postfix, ckp in models:
        inf = Inferencer(cfg, ckpt_path=ckp or None,
                         compute_dtype=(torch.bfloat16 if args.bf16
                                        else torch.float32),
                         exact=not args.bf16, device=dev)
        for spacing, add_bf in setups:
            tag = setup_tag(postfix, spacing, add_bf)
            save_dir = os.path.join(args.save_dir, tag)
            os.makedirs(save_dir, exist_ok=True)
            print(f"\nSetup {tag} -> {save_dir}")
            for p in paths:
                t0 = clock()
                subj = os.path.basename(p).split(".")[0]
                subj_dir = os.path.join(save_dir, subj)
                os.makedirs(subj_dir, exist_ok=True)
                im, aff, _, _ = prepare_image(
                    p, list(args.win), spacing=spacing, add_bf=add_bf,
                    device=dev)
                hemis = _hemis_mask(args, p, dev)
                if hemis is not None:
                    save_nifti(os.path.join(subj_dir, "hemis_mask.nii.gz"),
                               hemis.cpu().numpy(), aff)
                    im = im * hemis
                t1 = clock()
                outs = inf.evaluate_image(im, keep_feat=False)
                # deformed-atlas rendering from the predicted MNI coordinates
                # (parity: scripts/test.py:223-224)
                if all(k in outs for k in ("regx", "regy", "regz", "label")) \
                        and args.atlas and os.path.isfile(args.atlas):
                    outs["deformed_atlas"] = get_deformed_atlas(
                        outs["label"][0, ..., 0] > 0,
                        outs["regx"][0, ..., 0], outs["regy"][0, ..., 0],
                        outs["regz"][0, ..., 0], args.atlas)[None, ..., None]
                vols = {}
                for k, v in outs.items():
                    if k == "feat" or not torch.is_tensor(v) or v.dim() < 3:
                        continue
                    arr = v[0].float()
                    if hemis is not None and arr.shape[:3] == hemis.shape:
                        arr = arr * hemis[..., None]
                    vols[k] = arr
                del outs
                host = inf.fetch_outputs(vols, exclude_keys=())
                del vols
                t2 = clock()
                with ThreadPoolExecutor(max_workers=4) as ex:
                    list(ex.map(lambda kv: save_nifti(
                        os.path.join(subj_dir, f"out_{kv[0]}.nii.gz"),
                        np.squeeze(kv[1]), aff), host.items()))
                t3 = clock()
                if stats is not None:
                    stats.setdefault(tag, []).append({
                        "prepare_ms": (t1 - t0) * 1e3,
                        "forward_ms": (t2 - t1) * 1e3,
                        "write_ms": (t3 - t2) * 1e3,
                        "volume_ms": (t3 - t0) * 1e3})
                print("  done:", subj)


def run_pair_eval(args, cfg, device=None, stats=None):
    """File-pair scoring with the full protocol (Evaluator.eval_files:
    align, flip, kill labels, mask, one-hot dice over the evaluation
    list). Prints the per-metric table and writes scores.json. `stats`,
    when given, receives `score_ms`: per pair, the wall time of its
    scoring."""
    del cfg
    ev = Evaluator(args.metrics, labels=None, device=device)
    preds = sorted(glob.glob(args.pred_glob))
    rows = []
    for p in preds:
        gt = path_stem(p) + args.gt_suffix
        if not os.path.isfile(gt):
            continue
        t0 = time.perf_counter()
        res = ev.eval_files(
            p, gt, is_seg=args.is_seg or None, clamp=args.clamp,
            normalize=args.normalize, add_mask=args.add_mask,
            flip=args.flip,
            kill_target_labels=[int(v) for v in args.kill_labels])
        if stats is not None:
            stats.setdefault("score_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
        rows.append((os.path.basename(p), res))
        print(p, res)
    if rows:
        keys = list(rows[0][1])
        table = {k: float(np.mean([r[k] for _, r in rows])) for k in keys}
        print("\n== metric table (mean over %d pairs) ==" % len(rows))
        width = max(len(k) for k in keys)
        for k in keys:
            print(f"  {k:<{width}}  {table[k]:.4f}")
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "scores.json"), "w") as f:
            json.dump({"per_case": {n: r for n, r in rows},
                       "mean": table}, f, indent=1)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_glob", default=None,
                    help="run inference over these volumes")
    ap.add_argument("--pred_glob", default=None,
                    help="score these predictions against ground truth")
    ap.add_argument("--gt_suffix", default=".gt.nii.gz")
    ap.add_argument("--ckp_path", default=None)
    ap.add_argument("--models", nargs="*", default=[],
                    help="name=ckpt pairs (multi-model setups)")
    ap.add_argument("--spacings", nargs="*", default=["native"],
                    help="e.g. native 1,1,1 1.5,1.5,5 (multi-resolution)")
    ap.add_argument("--add_bf", action="store_true",
                    help="also run with a synthetic bias field applied")
    ap.add_argument("--save_dir", default="outs/test")
    ap.add_argument("--win", type=int, nargs=3, default=[220, 220, 220])
    ap.add_argument("--metrics", nargs="+",
                    default=["recon_l1", "recon_psnr", "recon_ssim"])
    ap.add_argument("--is_seg", action="store_true")
    ap.add_argument("--clamp", action="store_true")
    ap.add_argument("--normalize", action="store_true")
    ap.add_argument("--add_mask", action="store_true")
    ap.add_argument("--flip", action="store_true")
    ap.add_argument("--kill_labels", nargs="*", default=[])
    ap.add_argument("--hemis_seg_suffix", default=None,
                    help="suffix of the cerebral label map (hemis masking)")
    ap.add_argument("--hemis_regx_suffix", default=".mni_reg.x.nii.gz")
    ap.add_argument("--gen_cfg", default=None)
    ap.add_argument("--train_cfg", default=None)
    ap.add_argument("--atlas", default=None,
                    help="MNI atlas for deformed-atlas rendering; defaults "
                         "to the `atlas_path` config key, then "
                         "$BRAINFM_ATLAS_PATH, then files/gca.mgz")
    ap.add_argument("--bf16", action="store_true",
                    help="serve under bf16 autocast (default: fp32, TF32 "
                         "off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None, stats=None):
    """The CLI; `stats` (a dict) receives the stage times of
    run_inference_cases and run_pair_eval."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config([os.path.join(ROOT, "cfgs/generator/default.yaml"),
                       os.path.join(ROOT, "cfgs/trainer/default_train.yaml"),
                       os.path.join(ROOT, "cfgs/trainer/default_val.yaml"),
                       args.gen_cfg, args.train_cfg])
    if args.atlas is None:
        args.atlas = default_atlas_path(cfg)
    if args.input_glob:
        setups = parse_setups(args.spacings, [False, True] if args.add_bf
                              else [False])
        run_inference_cases(args, cfg, setups, dev, stats)
    if args.pred_glob:
        run_pair_eval(args, cfg, dev, stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
