"""The two-stage serving driver: drivers/serve.py's closed loop with the
two-stage pair in the model's place.

The traffic file's keys are serve.py's. A request is
`TwoStageInferencer.evaluate_path([path], save_dir, win_size=win,
exclude_keys=<every output not in write>, ext=".nii.gz")` on a
`TwoStageInferencer(compute_dtype=bfloat16, exact=False)` with the
configuration's pair and weights from the seed (infer/api.py): stage 0's
mask, stage 1 on the masked scan, the processors and postprocess. Its
latency runs from the call until the label file is on disk.

The output check is serve.py's (`compare`) against the plain two-stage
reference (reference/twostage.py) in float32 with TF32 off: the prepared
volume, the mask and every stage-1 output as the program handed them to
its fetch, and the written label map.
"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from .. import check, inputs
from ..record import Outcome, Spans, Window, log
from .serve import _AllBut, compare, label_file, make_inputs, \
    sampled_requests


def _inferencer(cfg_tree, seed, device):
    """The port's TwoStageInferencer with the seed's weights and a hook
    that keeps a sampled request's prepared volume and outputs."""
    from brainfm_tpu_torch.config import AttrDict
    from brainfm_tpu_torch.infer import TwoStageInferencer

    class Kept(TwoStageInferencer):
        keep = {}

        def begin(self, keep: bool):
            """The next request's volume is kept when `keep`:
            {"prepared", "outs"}."""
            self.keep = {} if keep else None

        def _prepare(self, path, win_size):
            out = super()._prepare(path, win_size)
            if self.keep is not None:
                self.keep["prepared"] = out[0]
            return out

        def fetch_outputs(self, outs, exclude_keys):
            if self.keep is not None:
                self.keep["outs"] = outs
            self.last_keys = sorted(k for k in outs
                                    if not k.startswith("feat"))
            return super().fetch_outputs(outs, exclude_keys)

    inf = Kept(AttrDict.from_nested(copy.deepcopy(cfg_tree)),
               compute_dtype=torch.bfloat16, exact=False, device=device)
    specs = inputs.weight_specs(inf.model)
    inputs.load_weights(inf.model, inputs.seed_weights(specs, seed, device))
    return inf


def reference(cfg_tree, seed, device, quant=None):
    """The plain reference pair with the seed's weights, and its processed
    config."""
    from ..reference import model as rm
    from ..reference import twostage as rt

    cfg, model = rt.build_model(rm.Cfg.from_nested(copy.deepcopy(cfg_tree)),
                                device)
    inputs.load_weights(model, inputs.seed_weights(
        inputs.weight_specs(model), seed, device))
    rm.set_arithmetic(model, quant)
    return cfg, model.eval()


def reference_outputs(cfg, model, path, win):
    """The plain reference's prepared volume and served outputs of one
    file, in float32 with TF32 off."""
    from ..reference import model as rm
    from ..reference import twostage as rt
    from ..reference.prepare import prepare_image

    dev = next(model.parameters()).device
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        im = prepare_image(path, list(win), device=dev)[0]
        with torch.no_grad():
            out = model(im[None, ..., None].float())
            out = rm.postprocess(rt.apply_processors(out, cfg), cfg)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return im, out


def run(cell, seed, seconds, trace, device, clock):
    from ..reference.utils.nifti import load_nifti
    from ..trace import Timeline, device_trace

    traffic, cfg_tree = cell.traffic, cell.config["cfg"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    win = tuple(int(w) for w in traffic["win"])
    work = tempfile.mkdtemp(prefix="brainbench-serve-twostage-")
    try:
        paths = make_inputs(traffic, seed, dev, work)
        inf = _inferencer(cfg_tree, seed, dev)
        served = os.path.join(work, "served")
        write = set(traffic["write"])

        def request(k, exclude, keep=False):
            save = os.path.join(served, f"r{k}")
            inf.begin(keep)
            inf.evaluate_path([paths[k % len(paths)]], save, win_size=win,
                              exclude_keys=exclude, ext=".nii.gz")
            return save

        # warm-up: every shape the traffic uses (one input shape); the
        # first call learns the output names, the window excludes all
        # that are not written
        shutil.rmtree(request(-1, _AllBut(write)), ignore_errors=True)
        exclude = tuple(k for k in inf.last_keys if k not in write)
        for k in range(int(traffic.get("warmup", 1))):
            shutil.rmtree(request(-2 - k, exclude), ignore_errors=True)
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = clock()

        sample = sampled_requests(seed, traffic)
        kept, latencies, failed = [], [], 0
        spans = Spans(bool(trace), sync)
        k = 0
        with device_trace(bool(trace) and dev.type == "cuda") as tr:
            sync()
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            while True:
                keep = k in sample
                r0 = time.perf_counter()
                try:
                    with spans("request"):
                        save = request(k, exclude, keep)
                except Exception as e:      # a failed request is counted
                    print(f"# request {k} failed: {e!r}", file=sys.stderr,
                          flush=True)
                    failed += 1
                    save = None
                latencies.append(time.perf_counter() - r0)
                if keep:
                    kept.append(dict(inf.keep, save=save,
                                     path=paths[k % len(paths)]))
                elif save is not None:
                    shutil.rmtree(save, ignore_errors=True)
                k += 1
                if time.perf_counter() - t0 >= seconds and k > sample[-1]:
                    break
            sync()
            elapsed, t1_ns = time.perf_counter() - t0, time.time_ns()
        n, done = k, k - failed
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        timeline = (Timeline(tr.events, t0_ns, t1_ns, spans.spans)
                    if tr.events is not None else None)
        window = Window(seconds=elapsed, done=done, cfg=cfg_tree,
                        traffic=traffic, spans=spans, timeline=timeline)
        del inf
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        per_request = []
        ref_cfg, ref_model = reference(cfg_tree, seed, dev) if kept \
            else (None, None)
        for i, rec in enumerate(kept):
            if rec["save"] is None or "outs" not in rec:
                per_request.append({"prep_gap": float("inf"),
                                    "head_gap": float("inf"),
                                    "heads_missing": 1, "label_miss": 1.0})
                continue
            written = load_nifti(label_file(rec["save"], rec["path"]))[0]
            ref_im, ref_out = reference_outputs(ref_cfg, ref_model,
                                                rec["path"], win)
            per_request.append(compare(rec["prepared"], rec["outs"],
                                       written, ref_im, ref_out))
            del ref_im, ref_out
            kept[i] = None
        checks = check.serve_checks(per_request)
        log(f"set-up {setup_s:.2f} s, window {elapsed:.2f} s, {n} requests "
            f"(sampled {sample}), reference {time.perf_counter() - t:.2f} s; "
            f"per request {per_request}")
        p90 = statistics.quantiles(latencies, n=10, method="inclusive")[8] \
            if len(latencies) > 1 else latencies[0]
        return Outcome(end_to_end={"setup_s": setup_s,
                                   "serve_vols_per_s": done / elapsed,
                                   "serve_p90_ms": p90 * 1e3},
                       window=window, attempted=n, failed=failed,
                       memory_peak_bytes=int(peak), checks=checks)
    finally:
        shutil.rmtree(work, ignore_errors=True)
