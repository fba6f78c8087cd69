"""Training logs (port of brainfm_tpu/utils/logging.py: setup_logging,
write_log_line, read_log, plot_loss).

Process rank comes from torch.distributed when a process group is up;
without one the process is rank 0.
"""

from __future__ import annotations

import json
import logging
import sys


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def setup_logging(output=None, name="brainfm_tpu_torch", rank0_only=True):
    """A logger to stdout and, when `output` is given, to that file; other
    ranks than 0 log nothing when rank0_only. Handlers are replaced, not
    added, when the same logger is set up again."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if rank0_only and _rank() != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s",
                            datefmt="%m/%d %H:%M:%S")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output:
        fh = logging.FileHandler(output)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def write_log_line(path, stats: dict):
    """Append one epoch of stats as a JSON line."""
    with open(path, "a") as f:
        f.write(json.dumps(stats) + "\n")


def read_log(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def plot_loss(log_path, out_path=None, keys=None):
    """Loss curves from the JSON-line log. Returns the figure path, or None
    when matplotlib is absent or a stub without `use` / `subplots`."""
    try:
        import matplotlib
    except ImportError:
        return None
    if not hasattr(matplotlib, "use"):  # stubbed module
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not hasattr(plt, "subplots"):
        return None

    stats = read_log(log_path)
    if not stats:
        return None
    keys = keys or [k for k in stats[0] if k.startswith("loss")]
    xs = [s.get("epoch", i) for i, s in enumerate(stats)]
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        ys = [s.get(k) for s in stats]
        if any(y is not None for y in ys):
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("epoch")
    ax.set_yscale("log")
    ax.legend(fontsize=7)
    out_path = out_path or str(log_path) + ".png"
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
