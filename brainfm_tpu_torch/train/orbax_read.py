"""The JAX package's orbax checkpoints, read without JAX, orbax or
tensorstore: a step directory that brainfm_tpu/train/checkpoint.py's
`save_checkpoint` wrote (orbax's StandardCheckpointer on {params,
opt_state, step}) as nested Python containers of CPU tensors.

The layout read here is the one that orbax writes by default:

    _METADATA            JSON: every leaf's key path (`key_metadata`: key
                         type 2 a dict key, 1 a sequence index) and value
                         type; `use_ocdbt` true, `use_zarr3` false
    manifest.ocdbt, d/, ocdbt.process_N/
                         one OCDBT key-value database (runtime/ocdbt.py)
                         holding each array as zarr v2: `<name>/.zarray`
                         and its chunks `<name>/<i>.<j>...`, <name> the key
                         path joined by '.'

Each `.zarray` gives the dtype (`<f4`, `<f8`, `<i4`, `<i8`, `|u1`, `|b1`,
`bfloat16`, ...), shape, chunk shape (one chunk per array from one device,
one per shard from a sharded save), memory order (C or F), fill value (a
missing chunk holds it) and compressor: zstd chunks are decoded by the
port's own decoder (runtime/zstd.py) on a thread pool, many at once.

An untargeted restore gives what orbax's untargeted restore gives: dicts
and lists where JAX had dicts, namedtuples and tuples (an optax state's
ScaleByAdamState is a dict with count, mu and nu), None for an empty
state, {} and [] for empty containers. Leaves are CPU tensors, or numpy
arrays for dtypes torch lacks.

A layout this reader does not take raises NotImplementedError naming
what it met (zarr v3, a save without OCDBT, another compressor, a value
type it does not know); malformed data raises ValueError. Nothing is
returned in either case.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from ..runtime import ocdbt, zstd

METADATA = "_METADATA"
_SEQ_INDEX = 1   # key_metadata's key type of a sequence index (2: a dict key)
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": list}
# the numpy dtypes that torch has (bfloat16 is handled apart)
_TORCH = frozenset({"<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1",
                    "|b1"})


def is_orbax_dir(path) -> bool:
    """Whether `path` is a step directory that orbax wrote."""
    p = Path(path)
    return p.is_dir() and ((p / METADATA).is_file()
                           or (p / "_CHECKPOINT_METADATA").is_file())


def _metadata(path: Path) -> dict:
    meta = path / METADATA
    if not meta.is_file():
        raise NotImplementedError(
            f"{path}: no {METADATA} (an orbax layout other than the "
            "PyTree checkpoint that save_checkpoint writes)")
    with open(meta) as f:
        m = json.load(f)
    if m.get("use_zarr3"):
        raise NotImplementedError(f"{path}: zarr v3 arrays (use_zarr3: "
                                  "true); only zarr v2 is read")
    if not m.get("use_ocdbt", False) or not ocdbt.is_database(path):
        raise NotImplementedError(
            f"{path}: a save without OCDBT (use_ocdbt: "
            f"{m.get('use_ocdbt')}, {ocdbt.MANIFEST} "
            f"{'present' if ocdbt.is_database(path) else 'absent'})")
    return m["tree_metadata"]


def _leaves(tree_metadata: dict, prefix: tuple):
    """(key path, key types, value type) of each leaf under `prefix`."""
    out = []
    for name, entry in tree_metadata.items():
        km = entry["key_metadata"]
        keys = tuple(str(k["key"]) for k in km)
        if keys[:len(prefix)] != prefix:
            continue
        kinds = tuple(int(k["key_type"]) for k in km)
        vtype = entry["value_metadata"]["value_type"]
        if vtype not in _ARRAY_TYPES and vtype not in _EMPTY:
            raise NotImplementedError(f"{name}: value type {vtype!r}")
        out.append((keys, kinds, vtype))
    return out


def _fill(value, dtype_name: str):
    """A zarr v2 fill value as a value of the stored dtype (bfloat16: its
    bits); null, orbax's, fills with zeros."""
    if value is None:
        return 0
    if isinstance(value, str):   # zarr v2 writes non-finite floats as text
        value = {"NaN": np.nan, "Infinity": np.inf,
                 "-Infinity": -np.inf}[value]
    if dtype_name == "bfloat16":
        return torch.tensor(float(value)).to(torch.bfloat16).view(
            torch.int16).item() & 0xFFFF
    return value


class _Array:
    """One zarr v2 array's metadata and chunk keys."""

    def __init__(self, name: str, zarray: dict):
        self.name = name
        if zarray.get("zarr_format") != 2:
            raise NotImplementedError(
                f"{name}: zarr_format {zarray.get('zarr_format')}")
        comp = zarray.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise NotImplementedError(f"{name}: compressor {comp.get('id')!r}"
                                      " (only zstd and none are read)")
        self.compressed = comp is not None
        if zarray.get("filters"):
            raise NotImplementedError(f"{name}: zarr filters "
                                      f"{zarray['filters']}")
        self.dtype_name = zarray["dtype"]
        if not isinstance(self.dtype_name, str):
            raise NotImplementedError(f"{name}: structured dtype "
                                      f"{self.dtype_name}")
        # bfloat16 is stored as its 16 bits, little-endian
        self.dtype = np.dtype("<u2" if self.dtype_name == "bfloat16"
                              else self.dtype_name)
        self.order = zarray.get("order", "C")
        if self.order not in ("C", "F"):
            raise ValueError(f"{name}: order {self.order!r}")
        self.shape = tuple(int(s) for s in zarray["shape"])
        self.chunks = tuple(int(c) for c in zarray["chunks"])
        if len(self.chunks) != len(self.shape) or min(self.chunks,
                                                      default=1) < 1:
            raise ValueError(f"{name}: chunks {self.chunks} for shape "
                             f"{self.shape}")
        sep = zarray.get("dimension_separator", ".")
        if sep not in (".", "/"):
            raise ValueError(f"{name}: dimension_separator {sep!r}")
        self.fill = _fill(zarray.get("fill_value"), self.dtype_name)
        grid = [math.ceil(s / c) for s, c in zip(self.shape, self.chunks)]
        self.chunk_index = [tuple(i) for i in np.ndindex(*grid)] \
            if self.shape else [()]
        self.keys = [f"{name}/{sep.join(map(str, i)) if i else '0'}".encode()
                     for i in self.chunk_index]
        self.chunk_bytes = math.prod(self.chunks) * self.dtype.itemsize

    def assemble(self, chunks: list):
        """The array from its chunks (uint8 buffers, or None: the fill
        value), in chunk_index order."""
        whole = (len(chunks) == 1 and self.chunks == self.shape
                 and chunks[0] is not None)
        if whole:
            a = chunks[0].view(self.dtype).reshape(self.shape,
                                                   order=self.order)
        else:
            a = np.full(self.shape, self.fill, self.dtype)
            for idx, buf in zip(self.chunk_index, chunks):
                if buf is None:
                    continue
                c = buf.view(self.dtype).reshape(self.chunks,
                                                 order=self.order)
                sl = tuple(slice(i * n, min((i + 1) * n, s))
                           for i, n, s in zip(idx, self.chunks, self.shape))
                a[sl] = c[tuple(slice(0, s.stop - s.start) for s in sl)]
        if not a.dtype.isnative:
            a = a.astype(a.dtype.newbyteorder("="))
        if not a.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
            a = a.copy(order="C")
        if self.dtype_name == "bfloat16":
            return torch.from_numpy(a).view(torch.bfloat16)
        if a.dtype.str in _TORCH:
            return torch.from_numpy(a)
        return a


def restore(path, prefix=None):
    """The checkpoint at step directory `path` (or, with `prefix`, a key
    path such as ("params",), only that subtree: nothing outside it is
    read or decoded) as nested dicts and lists of CPU tensors.

    Raises NotImplementedError for a layout this reader does not take,
    ValueError for malformed data and KeyError when `prefix` names no
    leaf."""
    path = Path(path)
    prefix = tuple(str(p) for p in (prefix or ()))
    leaves = _leaves(_metadata(path), prefix)
    if not leaves:
        raise KeyError(f"{path}: no leaf under {prefix}")
    store = ocdbt.OcdbtStore(path)
    names = {keys: ".".join(keys) for keys, _, vt in leaves
             if vt in _ARRAY_TYPES}
    zkeys = {n: f"{n}/.zarray".encode() for n in names.values()}
    meta = store.read_many(zkeys.values())
    arrays = {}
    for keys, name in names.items():
        raw = meta.get(zkeys[name])
        if raw is None:
            raise ValueError(f"{path}: no {name}/.zarray in the checkpoint")
        arrays[keys] = _Array(name, json.loads(raw))
    values = store.read_many([k for a in arrays.values() for k in a.keys])
    frames, sizes, owners = [], [], []
    for keys, a in arrays.items():
        for j, k in enumerate(a.keys):
            v = values.get(k)
            if v is None:
                continue
            if a.compressed:
                frames.append(v)
                sizes.append(a.chunk_bytes)
                owners.append((keys, j))
            elif len(v) != a.chunk_bytes:
                raise ValueError(f"{k.decode()}: {len(v)} bytes, a chunk of "
                                 f"{a.chunks} {a.dtype_name} has "
                                 f"{a.chunk_bytes}")
    try:
        buf, offs = zstd.decode_batch(frames, sizes)
    except zstd.ZstdError as e:
        keys, j = owners[e.index]
        raise ValueError(f"{path}: {arrays[keys].keys[j].decode()}: {e}") \
            from e
    decoded = {own: buf[o:o + s] for own, o, s in zip(owners, offs, sizes)}
    out = {}
    for keys, kinds, vtype in leaves:
        if vtype in _EMPTY:
            out[keys] = (kinds, _EMPTY[vtype]())
            continue
        a = arrays[keys]
        chunks = []
        for j, k in enumerate(a.keys):
            v = decoded.get((keys, j))
            if v is None and k in values and not a.compressed:
                v = np.frombuffer(values[k], np.uint8).copy()
            chunks.append(v)
        leaf = a.assemble(chunks)
        if vtype == "scalar":
            leaf = leaf.item()
        out[keys] = (kinds, leaf)
    return _nest(out, len(prefix))


def _nest(leaves: dict, skip: int):
    """Nested dicts and lists from {key path: (key types, leaf)}, each
    path with its first `skip` keys dropped."""
    root: dict = {}
    kinds_of: dict = {}
    for keys, (kinds, leaf) in leaves.items():
        keys, kinds = keys[skip:], kinds[skip:]
        if not keys:
            return leaf
        node = root
        for depth, (k, kind) in enumerate(zip(keys, kinds)):
            kinds_of[keys[:depth + 1]] = kind
            if depth == len(keys) - 1:
                node[k] = leaf
            else:
                node = node.setdefault(k, {})

    def build(node, path):
        if not isinstance(node, dict):
            return node
        kids = {k: build(v, path + (k,)) for k, v in node.items()}
        child_kinds = {kinds_of[path + (k,)] for k in node}
        if child_kinds == {_SEQ_INDEX}:
            idx = sorted(int(k) for k in kids)
            out = [None] * (idx[-1] + 1)
            for k, v in kids.items():
                out[int(k)] = v
            return out
        if _SEQ_INDEX in child_kinds:
            raise ValueError(f"{path}: mixed dict keys and sequence indices")
        return kids

    return build(root, ())
