"""Cascading YAML configuration (port of brainfm_tpu/config/config.py).

A list of YAML files is merged left to right (later files override earlier
ones, recursively) into an attribute-accessible dict whose absent keys read
as None.
"""

from __future__ import annotations

import copy
import os
import re
import time
from types import SimpleNamespace

import yaml


class AttrDict(dict):
    """dict with attribute access; missing keys read as None."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            return None

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_nested(d):
        if isinstance(d, dict):
            return AttrDict({k: AttrDict.from_nested(v) for k, v in d.items()})
        if isinstance(d, list):
            return [AttrDict.from_nested(v) for v in d]
        return d


_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


class _SciFloatLoader(yaml.SafeLoader):
    """SafeLoader plus an implicit float resolver for dot-less scientific
    notation ('1e-4'), which YAML 1.1 parses as a string. It fires only on
    plain (unquoted) scalars, so a quoted "1e5" stays a string."""


_SciFloatLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _SCI_FLOAT, list("-+0123456789."))


def recursive_update(base: dict, overrides: dict) -> dict:
    """Merge `overrides` into `base` in place, recursing into nested dicts."""
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            recursive_update(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.load(f, Loader=_SciFloatLoader) or {}


def load_config(cfg_files, cfg_dir: str = "") -> AttrDict:
    """Cascade-merge a list of YAML files. None entries are skipped;
    relative entries are resolved against `cfg_dir` when they do not exist
    as given, and '.yaml' is appended when missing."""
    merged: dict = {}
    for f in cfg_files:
        if f is None or f == "":
            continue
        path = f
        if not os.path.isfile(path) and cfg_dir:
            path = os.path.join(cfg_dir, f)
        if not os.path.isfile(path) and not path.endswith((".yaml", ".yml")):
            path = path + ".yaml"
        recursive_update(merged, load_yaml(path))
    return AttrDict.from_nested(merged)


def preprocess_cfg(cfg_files, cfg_dir: str = "") -> AttrDict:
    """The reference's name for `load_config` (utils/misc.py:378 of the
    reference)."""
    return load_config(cfg_files, cfg_dir)


def to_namespace(d):
    """A nested dict, and the lists inside it, as a SimpleNamespace tree,
    for call sites that read the reference's `args.x.y`."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: to_namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return [to_namespace(v) for v in d]
    return d


def merge_missing(dst: dict, src: dict) -> dict:
    """Fill keys of `dst` that are absent or None from `src`, recursively:
    how a trainer config takes in its generator config (the merge of
    scripts/train.py)."""
    for k, v in src.items():
        if k not in dst or dst[k] is None:
            dst[k] = v
        elif hasattr(dst[k], "items") and hasattr(v, "items"):
            merge_missing(dst[k], v)
    return dst


def update_out_dir(cfg: AttrDict, out_root: str = "outs") -> AttrDict:
    """Timestamp the run's output directory: cfg.out_dir =
    <out_root>/<job_name>-<exp_name>-<YYYYmmdd-HHMMSS>. Under
    torch.distributed every rank takes rank 0's time (broadcast), so a run
    whose ranks straddle a second boundary still writes one directory."""
    t = int(time.time())
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        box = [t]
        dist.broadcast_object_list(box, src=0)
        t = int(box[0])
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(t))
    cfg.out_dir = os.path.join(out_root, f"{cfg.job_name or 'job'}-"
                               f"{cfg.exp_name or 'exp'}-{stamp}")
    return cfg
