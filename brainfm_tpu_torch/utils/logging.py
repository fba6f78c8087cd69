"""Training logs and meters (port of brainfm_tpu/utils/logging.py:
setup_logging, SmoothedValue, MetricLogger, write_log_line, read_log,
plot_loss).

Process rank comes from torch.distributed when a process group is up;
without one the process is rank 0, and the meters' synchronization does
nothing.
"""

from __future__ import annotations

import datetime
import json
import logging
import sys
import time
from collections import defaultdict, deque

import numpy as np


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


class SmoothedValue:
    """Windowed meter (parity: utils/misc.py:647-709)."""

    def __init__(self, window_size=20, fmt="{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def synchronize_between_processes(self):
        """Sum count and total over the ranks of the process group (the
        window stays local), as misc.py:676-690."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t)
        self.count = int(t[0])
        self.total = float(t[1])

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """(parity: utils/misc.py:712-840)"""

    def __init__(self, delimiter="  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable, print_freq, logger, header="", total=None):
        i = 0
        total = total if total is not None else len(iterable)
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i)
                logger.info(
                    f"{header} [{i}/{total}] eta: "
                    f"{datetime.timedelta(seconds=int(eta))} {self} "
                    f"time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        logger.info(f"{header} Total time: "
                    f"{datetime.timedelta(seconds=int(elapsed))} "
                    f"({elapsed / max(total, 1):.4f} s / it)")


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
