"""The port's read-only OCDBT store (brainfm_tpu_torch/runtime/ocdbt.py)
against tensorstore's `ocdbt` kvstore, which writes the databases here:
small nodes (so the b-tree grows interior nodes), values all indirect
(max_inline_value_bytes 0) or all inline, zstd-compressed and raw nodes,
several commits with overwrites and deletions (the newest version is
read), a version tree with nodes of its own, an emptied database; then
the refusals (a numbered manifest, checksums, truncation)."""

import numpy as np
import pytest
import tensorstore as ts

from brainfm_tpu_torch.runtime.ocdbt import OcdbtStore

PREFIXES = (b"", b"a", b"ab", b"k/", b"k/0", b"k/1", b"\xff", b"zz",
            b"params.", b"k/00/\xfe")


def _open(path, **config):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{path}/",
                            "config": config}).result()


def _fill(kv, seed, n_commits=3, n_keys=120):
    """Commits of random keys (shared prefixes, bytes up to 0xff) and
    values (0-3000 bytes); later commits overwrite and delete."""
    rng = np.random.default_rng(seed)
    keys = sorted({b"k/%02d/" % rng.integers(0, 30) + rng.bytes(
        int(rng.integers(0, 6))) for _ in range(n_keys)}
        | {b"a", b"ab", b"abc", b"\xff\xff", b"params.x/.zarray"})
    for c in range(n_commits):
        txn = ts.Transaction()
        for k in keys:
            r = rng.random()
            if r < 0.6:
                kv.with_transaction(txn)[k] = rng.bytes(
                    int(rng.integers(0, 3000)))
            elif r < 0.7 and c:
                del kv.with_transaction(txn)[k]
        txn.commit_async().result()


def _assert_same(kv, path):
    store = OcdbtStore(path)
    want = sorted(kv.list().result())
    assert store.list() == want
    for p in PREFIXES:
        assert store.list(p) == [k for k in want if k.startswith(p)], p
    values = {k: kv.read(k).result().value for k in want}
    for k in want[::7]:
        assert store.read(k) == values[k]
    asked = want[::2] + [b"k/99/missing", b"\x00"]
    got = store.read_many(asked)
    assert got == {k: values[k] for k in want[::2]}
    with pytest.raises(KeyError):
        store.read(b"k/99/missing")
    return store


@pytest.mark.parametrize("compression", [{"id": "zstd"}, None])
@pytest.mark.parametrize("inline", [0, 1 << 20])
def test_list_and_read_equal_tensorstore(tmp_path, inline, compression):
    config = {"max_inline_value_bytes": inline,
              "max_decoded_node_bytes": 256}
    if compression:
        config["compression"] = compression
    kv = _open(tmp_path, **config)
    _fill(kv, seed=inline % 7 + (compression is None))
    store = _assert_same(kv, tmp_path)
    assert store.max_inline_value_bytes == inline
    assert store.height >= 2   # interior nodes above the leaves


def test_interior_nodes_and_a_version_tree(tmp_path):
    """Version-tree arity 2 and 12 commits: the older versions sit in
    version-tree nodes and the newest is read; 256-byte nodes give a
    b-tree of several heights."""
    kv = _open(tmp_path, max_decoded_node_bytes=256,
               version_tree_arity_log2=1, compression={"id": "zstd"})
    for i in range(12):
        kv[b"k/%03d" % i] = b"v" * i
        kv[b"k/000"] = b"newest %d" % i
    store = _assert_same(kv, tmp_path)
    assert store.generation == 25 and store.height >= 1
    assert store.read(b"k/000") == b"newest 11"


def test_emptied_database(tmp_path):
    kv = _open(tmp_path)
    kv[b"a"] = b"b"
    del kv[b"a"]
    store = OcdbtStore(tmp_path)
    assert store.list() == [] and store.read_many([b"a"]) == {}
    with pytest.raises(KeyError):
        store.read(b"a")


def test_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        OcdbtStore(tmp_path / "none")
    numbered = tmp_path / "numbered"
    kv = _open(numbered, manifest_kind="numbered")
    kv[b"a"] = b"b"
    with pytest.raises(NotImplementedError, match="manifest kind"):
        OcdbtStore(numbered)

    db = tmp_path / "db"
    kv = _open(db, max_inline_value_bytes=0, max_decoded_node_bytes=256)
    _fill(kv, seed=5, n_commits=1)
    manifest = (db / "manifest.ocdbt").read_bytes()
    bad = bytearray(manifest)
    bad[20] ^= 1
    (db / "manifest.ocdbt").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(db)
    (db / "manifest.ocdbt").write_bytes(manifest[:-9])
    with pytest.raises(ValueError):
        OcdbtStore(db)
    (db / "manifest.ocdbt").write_bytes(manifest)
    data = sorted((db / "d").iterdir())
    for f in data:
        f.write_bytes(f.read_bytes()[:-3])   # cut every data file short
    store = OcdbtStore(db)
    with pytest.raises(ValueError):
        store.read_many([b"a", b"ab", b"abc"])
