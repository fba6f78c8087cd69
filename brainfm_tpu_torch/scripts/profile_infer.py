"""Where the whole-volume forward's time goes, stage by stage.

    python -m brainfm_tpu_torch.scripts.profile_infer          # on CUDA

The port's twin of the root `scripts/profile_infer.py`: the bench's
served model (the joint 8-task L6 f_maps-64 UNet3D, random weights from
seed 0, bf16 autocast) on a 220^3 volume from `default_rng(0)`, timed in
four stages, each on its own, one warm-up then REPS calls with a pair of
CUDA events each (`utils/profiling.py::call_times`; median, min, max):

- encoders: the encoder tower only;
- backbone: encoders and decoders (`get_feature`);
- heads: the fused task heads on the backbone's features, the outputs
  lifted to fp32 and `apply_processors`;
- postprocess: `models/build.py::postprocess` on those outputs (the
  label map's lookup runs on K2; its launches are counted);

and, beside them, the whole `Inferencer` forward (`keep_feat=False`), the
primary stage of `python -m brainfm_tpu_torch.bench`. One JSON line per
stage, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from brainfm_tpu_torch import bench, kernels
from brainfm_tpu_torch.device import card_label, resolve_device
from brainfm_tpu_torch.models.build import (_head_out, _model_input,
                                            process_outputs)
from brainfm_tpu_torch.models.unet3d import _encode
from brainfm_tpu_torch.utils.profiling import call_times

REPS = 5


def profile(shape, dev, reps=REPS):
    """One record per stage of the bench's served model at `shape` (a
    `bench.SHAPES` entry) on `dev`, each timed over `reps` calls."""
    from brainfm_tpu_torch.infer import Inferencer

    inf = Inferencer(bench.model_cfg(bench.INFER_CFG, shape, shape["win"]),
                     compute_dtype=torch.bfloat16, exact=False, device=dev)
    model, cfg = inf.model, inf.cfg
    v = np.random.default_rng(0).random((shape["vol"],) * 3)
    x = torch.from_numpy(v).float().to(dev)[None, ..., None]
    xin = _model_input(x)

    def amp():
        return torch.autocast(dev.type, dtype=torch.bfloat16)

    def encoders():
        with amp():
            return _encode(model.backbone.encoders, xin)

    def backbone():
        with amp():
            return model.backbone.get_feature(xin)

    def heads(feats):
        with amp():
            out = {k: _head_out(t) for k, t in model.head(feats).items()}
        return process_outputs(model, {k: t.float() for k, t in out.items()},
                               cfg)

    def measure(name, fn):
        kernels.reset_launches()
        times = call_times(fn, dev, reps)
        return {"stage": name, "size": shape["vol"],
                "f_maps": shape["f_maps"],
                "num_levels": shape["num_levels"], "dtype": "bf16",
                "ms": statistics.median(times), "ms_min": min(times),
                "ms_max": max(times), "calls": reps + 1,
                "launches": dict(kernels.LAUNCHES)}

    with torch.inference_mode():
        yield measure("encoders", encoders)
        yield measure("backbone", backbone)
        feats = backbone()
        yield measure("heads", lambda: heads(feats))
        outs = heads(feats)
        del feats
        yield measure("postprocess", lambda: inf._post(outs, x))
        del outs
        yield measure("forward", lambda: inf._forward(x, keep_feat=False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: CUDA")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    for rec in profile(bench.SHAPES["full"], dev):
        print(json.dumps({**rec, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
