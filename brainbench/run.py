"""One cell of the benchmark of brainfm_tpu_torch, run once on one H100.

    python3 -m brainbench.run --workload joint.train --seed 7 \\
        --seconds 51 --trace 0

Reads the cell from BENCHMARK.json and its files under brainbench/ (see
cells.py), sets up the program under test with inputs and weights from
`--seed`, measures for `--seconds`, then checks the timed path's outputs
against the plain reference (brainbench/reference/). With `--trace 0` the
result's metrics are the cell's end-to-end metrics; with `--trace 1` the
window runs under torch.profiler and the harness's spans, and the metrics
are the cell's per-layer ones (brainbench/metrics/<name>.py).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with `--trace 1`
`breakdown`), and last `checks`, each number of the output check with its
limit; the same numbers are the last lines of standard error. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded at the end, the run prints no result and exits 2. Build
and kernel caches live under .brainbench_cache/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".brainbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "brainfm_tpu")


def process_start() -> float:
    """The Unix time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs():
    """Every compiler cache PyTorch may use, at fixed paths inside the
    checkout, so only a checkout's first run builds."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell, seed, seconds, trace, device, started):
    """Run `cell` once on `device`; the result object. `started`: the Unix
    time the run began (its set-up is counted from there)."""
    import importlib

    import torch

    from . import check, cells

    driver = importlib.import_module(
        f"brainbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed, seconds, trace, device,
                     lambda: time.time() - started)
    correct, table = check.judge(out.checks, cell.limits)
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": int(out.devices),
                   "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(correct) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed}
    w = out.window
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if w.timeline is not None:
            device_info["busy_s"] = w.timeline.busy_s
            device_info["window_s"] = w.timeline.window_s
            result["breakdown"] = {"device_ops": w.timeline.device_ops(),
                                   "idle_gaps": w.timeline.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = table
    return result


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    started = process_start()
    args = build_parser().parse_args(argv)
    set_cache_dirs()
    import torch

    from . import cells
    from .record import log

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"FATAL: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count {torch.cuda.device_count()}")
        return 2
    power = _power_limit()
    log(f"cell {cell.name} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace} on {power}")
    result = execute(cell, args.seed, args.seconds, args.trace, "cuda",
                     started)
    bad = forbidden_modules()
    if bad:
        log(f"FATAL: modules loaded that the port must not use: {bad}")
        return 2
    for k, v in result["metrics"].items():
        log(f"{k} = {v['value']} {v['unit']}")
    log(f"correct {result['correct']}, attempted {result['attempted']}, "
        f"failed {result['failed']}, card {power}")
    for k, v in result["checks"].items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
