"""A read-only OCDBT key-value store: tensorstore's "Optionally-Cooperative
Distributed B+Tree" on-disk format, in which orbax writes the zarr arrays
of a checkpoint (train/orbax_read.py).

A database is a directory holding `manifest.ocdbt` and data files (`d/...`,
or, for orbax's merged root, `ocdbt.process_N/d/...`). The manifest names
the configuration and the versions; the newest version's root b-tree node
leads to every key. Manifests and nodes are

    magic (u32 big-endian) | length (u64) | format version (varint, 0) |
    compression (varint: 0 none, 1 zstd) | body | CRC-32C (u32)

with the body zstd-compressed (runtime/zstd.py) when the compression says
so. A manifest body is the config (uuid, manifest kind, inline-value and
node-size limits, version-tree arity, compression), a data-file table and
the newest versions' list; older versions sit in version-tree nodes,
which are not needed to read the newest. A node body is its height, a
data-file table and its entries, stored field by field: keys
prefix-compressed against the previous key, and in interior nodes each
child's common key prefix, its location (data file, offset, length) and
statistics; in leaves each value's length and kind, inline bytes or a
(data file, offset) reference. Data-file paths are relative to the
database directory, prefix-compressed over the table.

Integers are little-endian; varints are LEB128. Only manifests of the
`single` kind are read (orbax writes no other); another kind raises
NotImplementedError. Malformed input raises ValueError.
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

from . import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1   # an empty version's root offset and length
_MAX_BODY = 1 << 31


class _Cursor:
    """Reads the fields of a decoded body; `what` names it in errors."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u32(self) -> int:
        return int.from_bytes(self.bytes(4), "little")

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long at byte "
                                 f"{self.pos}")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _frame(raw: bytes, magic: int, what: str) -> _Cursor:
    """Check a manifest or node's header and checksum; its body."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes, too short")
    if int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: magic {raw[:4].hex()}, expected "
                         f"{magic:08x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: length field {length}, {len(raw)} bytes "
                         "read")
    crc = int.from_bytes(raw[-4:], "little")
    if zstd.crc32c(raw[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Cursor(raw[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise NotImplementedError(f"{what}: OCDBT format version {version}")
    body = raw[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body, max_size=_MAX_BODY)
    elif compression != 0:
        raise NotImplementedError(f"{what}: compression format "
                                  f"{compression}")
    return _Cursor(body, what)


def _data_files(c: _Cursor) -> list:
    """A data-file table: the paths, relative to the database directory."""
    n = c.varint()
    if n == 0:
        return []
    prefix = [0] + c.varints(n - 1)
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data-file prefix {prefix[i]} > "
                             f"{len(prev)}")
        full = prev[:prefix[i]] + c.bytes(suffix[i])
        if base[i] > len(full):
            raise ValueError(f"{c.what}: base path longer than its path")
        path = full.decode()
        parts = path.split("/")
        if path.startswith("/") or ".." in parts:
            raise ValueError(f"{c.what}: data file {path!r} outside the "
                             "database")
        paths.append(path)
        prev = full
    return paths


def _keys(c: _Cursor, n: int):
    """The prefix and suffix lengths of n prefix-compressed keys."""
    prefix = [0] + c.varints(n - 1)
    suffix = c.varints(n)
    return prefix, suffix


def _expand(c: _Cursor, prefix, suffix) -> list:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{c.what}: key prefix {p} > {len(prev)}")
        prev = prev[:p] + c.bytes(s)
        keys.append(prev)
    return keys


class _Leaf:
    __slots__ = ("keys", "values")

    def __init__(self, keys, values):
        # a value: inline bytes, or (data file, offset, length)
        self.keys, self.values = keys, values


class _Interior:
    __slots__ = ("keys", "common", "children")

    def __init__(self, keys, common, children):
        # children: (path, offset, length); common: subtree prefix lengths
        self.keys, self.common, self.children = keys, common, children


class OcdbtStore:
    """The newest version of the OCDBT database in directory `root`
    (`generation`: its number; `height`: its b-tree's, 0 a lone leaf).

    list(prefix): the sorted keys that start with `prefix`; read(key): a
    value (KeyError if absent); read_many(keys): {key: value} of those
    present, reading each data file once, in offset order. Keys and
    values are bytes."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / MANIFEST
        if not path.is_file():
            raise FileNotFoundError(f"no {MANIFEST} in {self.root}")
        self._nodes: dict = {}
        c = _frame(path.read_bytes(), MANIFEST_MAGIC, str(path))
        c.bytes(16)                               # uuid
        kind = c.varint()
        if kind != 0:
            raise NotImplementedError(
                f"{path}: manifest kind {kind} (only 'single', 0, is read)")
        self.max_inline_value_bytes = c.varint()
        self.max_decoded_node_bytes = c.varint()
        c.byte()                                  # version-tree arity log2
        if c.varint() == 1:                       # zstd: its level
            c.u32()
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"{path}: no versions")
        gens = c.varints(n)
        heights = [c.byte() for _ in range(n)]
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        self.generation, self.height = gens[-1], heights[-1]
        if offs[-1] == _NO_ROOT:
            self._root = None                     # the empty database
        else:
            self._root = (self._file(files, fids[-1], path), offs[-1],
                          lens[-1], heights[-1])

    @staticmethod
    def _file(files, fid, what):
        if fid >= len(files):
            raise ValueError(f"{what}: data file {fid} of {len(files)}")
        return files[fid]

    def _node(self, ref):
        path, offset, length, height = ref
        key = (path, offset)
        node = self._nodes.get(key)
        if node is not None:
            return node
        full = self.root / path
        what = f"{full}@{offset}"
        with open(full, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise ValueError(f"{what}: {len(raw)} of {length} bytes")
        c = _frame(raw, NODE_MAGIC, what)
        if c.byte() != height:
            raise ValueError(f"{what}: not of height {height}")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"{what}: no entries")
        prefix, suffix = _keys(c, n)
        if height == 0:
            keys = _expand(c, prefix, suffix)
            lens = c.varints(n)
            kinds = c.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError(f"{what}: value kind {max(kinds)}")
            ind = [i for i in range(n) if kinds[i] == 1]
            fids, offs = c.varints(len(ind)), c.varints(len(ind))
            values: list = [None] * n
            for i, fid, off in zip(ind, fids, offs):
                values[i] = (self._file(files, fid, what), off, lens[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = c.bytes(lens[i])
            node = _Leaf(keys, values)
        else:
            common = c.varints(n)
            keys = _expand(c, prefix, suffix)
            if any(cp > len(k) for cp, k in zip(common, keys)):
                raise ValueError(f"{what}: subtree prefix beyond its key")
            fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)                      # statistics
            node = _Interior(keys, common, [
                (self._file(files, fid, what), off, ln, height - 1)
                for fid, off, ln in zip(fids, offs, lens)])
        if c.pos != len(c.data):
            raise ValueError(f"{what}: {len(c.data) - c.pos} bytes after "
                             "its entries")
        self._nodes[key] = node
        return node

    def _walk(self, lo: bytes, hi: bytes | None):
        """(key, value) of every key in [lo, hi) (hi None: no bound), in
        key order."""
        if self._root is None:
            return
        stack = [(self._root, b"")]
        while stack:
            ref, base = stack.pop()
            node = self._node(ref)
            full = [base + k for k in node.keys]
            if isinstance(node, _Leaf):
                yield from ((k, v) for k, v in zip(full, node.values)
                            if k >= lo and (hi is None or k < hi))
                continue
            todo = []
            for i, k in enumerate(full):
                # child i holds keys in [full[i], full[i + 1])
                if hi is not None and k >= hi:
                    break
                if i + 1 < len(full) and full[i + 1] <= lo:
                    continue
                todo.append((node.children[i],
                             base + node.keys[i][:node.common[i]]))
            stack.extend(reversed(todo))

    def list(self, prefix: bytes = b"") -> list:
        return [k for k, _ in self._walk(prefix, _after(prefix))]

    def _value(self, v, f=None) -> bytes:
        if isinstance(v, bytes):
            return v
        path, offset, length = v
        full = self.root / path
        if f is None:
            with open(full, "rb") as fh:
                return self._value(v, fh)
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{full}: value at {offset} truncated "
                             f"({len(data)} of {length} bytes)")
        return data

    def read(self, key: bytes) -> bytes:
        for k, v in self._walk(key, key + b"\0"):
            if k == key:
                return self._value(v)
        raise KeyError(key)

    def read_many(self, keys) -> dict:
        want = set(keys)
        if not want:
            return {}
        found = {k: v for k, v in self._walk(min(want),
                                              max(want) + b"\0")
                 if k in want}
        out = {k: v for k, v in found.items() if isinstance(v, bytes)}
        by_file = defaultdict(list)
        for k, v in found.items():
            if not isinstance(v, bytes):
                by_file[v[0]].append((v[1], k, v))
        for path, refs in by_file.items():
            with open(self.root / path, "rb") as f:
                for _, k, v in sorted(refs):
                    out[k] = self._value(v, f)
        return out


def _after(prefix: bytes):
    """The smallest key above every key that starts with `prefix` (None:
    no bound)."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


def is_database(path) -> bool:
    return os.path.isfile(os.path.join(str(path), MANIFEST))
