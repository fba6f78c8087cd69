"""The port's reader of the JAX package's orbax checkpoints
(brainfm_tpu_torch/train/orbax_read.py) and the entry points that use it,
against the JAX package and orbax on the CPU: every leaf of a TrainState
that brainfm_tpu.train.checkpoint.save_checkpoint wrote equals orbax's own
restore bitwise (bf16, int and bool leaves, a sharded save with several
chunks per array, and zarr layouts that tensorstore writes: '/' chunk
keys, F order, fill values, edge chunks); Inferencer and
TwoStageInferencer on such directories equal the JAX ones at fp64 without
reading the optimizer's chunks; load_checkpoint then one port step equals
the JAX step; train(resume=) continues a JAX run; the committed fixtures
read alike by both; and every layout the reader does not take raises."""

import contextlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import torch

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brainfm_tpu.config import AttrDict as JAttrDict
from brainfm_tpu.config import load_config as jload
from brainfm_tpu.infer import api as japi
from brainfm_tpu.models import build_model as jbuild
from brainfm_tpu.models.build import apply_processors as japply
from brainfm_tpu.models.build import build_inpaint_model as jinpaint
from brainfm_tpu.models.criterion import make_criterion as jcriterion
from brainfm_tpu.models.criterion import weighted_total as jweighted
from brainfm_tpu.train import step as jstep
from brainfm_tpu.train.checkpoint import save_checkpoint as jsave
from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.config import load_config as tload
from brainfm_tpu_torch.infer import Inferencer, TwoStageInferencer
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.models.params_io import find_state
from brainfm_tpu_torch.runtime import ocdbt
from brainfm_tpu_torch.synth import SubjectBank
from brainfm_tpu_torch.train import checkpoint as ckpt
from brainfm_tpu_torch.train import loop, orbax_read
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_train_step)

from _torch_train_util import (jax_params_as_port, joint_cfg, np_batch,
                               port_params, rel_l2, to_jax, to_torch)
import _torch_dist as td
import _torch_orbax_fixtures as fixtures

# tests/test_torch_serve.py's: fp64 on both sides, only summation order
F64_ATOL = 1e-9
# tests/test_torch_train.py's: fp64 steps
LOSS_RTOL = 1e-10
PARAM_REL_L2 = 1e-9
LR, WD = 1e-3, 1e-2


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _bits(a):
    """A leaf as a numpy array of its exact bits (bf16 as uint16)."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_tree(want, got, path=""):
    """orbax's restore `want` and the port's `got`: the same containers
    (dicts; lists where orbax gives lists or tuples) and bitwise leaves of
    the same dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_tree(w, g, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        w, g = _bits(want), _bits(got)
        assert w.dtype == g.dtype and w.shape == g.shape, (path, w.dtype,
                                                            g.dtype)
        assert np.array_equal(w, g, equal_nan=w.dtype.kind == "f"), path


def orbax_restore(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def serve_cfg():
    """tests/test_torch_serve.py's small model (unit_feat off)."""
    return dict(task={t: True for t in ("T1", "CT", "segmentation",
                                        "distance", "bias_field",
                                        "registration")},
                generator={"left_hemis_only": False, "size": [32, 32, 32]},
                losses={"uncertainty": None}, backbone="unet3d", f_maps=8,
                num_levels=3, num_groups=8, layer_order="gcl",
                unit_feat=False, task_f_maps=[8], max_surf_distance=3.0)


def _save_state(ckp, step, params, optimizer, extra=None):
    state = jstep.TrainState(params, optimizer.init(params),
                             jnp.asarray(step, jnp.int32))
    return jsave(str(ckp), step, state, extra=extra)


# ------------------------------------------------------------ restore

def test_restore_equals_orbax_bitwise_every_dtype(tmp_path):
    """A TrainState whose params hold f32, bf16, int32, uint8 and bool
    leaves (the small joint model's plus extras) and its AdamW state:
    orbax's untargeted restore and the port's agree in containers and
    bits; a prefix reads only its subtree."""
    jcfg, jm = jbuild(JAttrDict.from_nested(serve_cfg()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, 16, 16, 16, 1)))
    rng = np.random.default_rng(0)
    params = {"params": params["params"], "extra": {
        "bf16": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
        "i32": jnp.asarray(rng.integers(-9, 9, (3, 4)), jnp.int32),
        "u8": jnp.asarray(rng.integers(0, 255, (6,)), jnp.uint8),
        "flag": jnp.asarray(rng.random((2, 3)) < 0.5)}}
    path = _save_state(tmp_path / "ckp", 7, params, optax.adamw(1e-3))
    want = orbax_restore(path)
    got = orbax_read.restore(path)
    assert_same_tree(want, got)
    assert got["params"]["extra"]["bf16"].dtype == torch.bfloat16
    assert_same_tree(want["params"], orbax_read.restore(path, ("params",)))
    assert_same_tree(want["params"]["extra"]["u8"], orbax_read.restore(
        path, ("params", "extra", "u8")))
    assert int(got["step"]) == 7
    with pytest.raises(KeyError):
        orbax_read.restore(path, ("nothing",))


def test_sharded_save_has_a_chunk_per_shard(tmp_path):
    """Arrays sharded over 4 of the test process's 8 CPU devices (over
    one axis and over two): orbax writes one chunk per shard, and the
    port assembles them bitwise."""
    devs = np.array(jax.devices()[:4])
    mesh1, mesh2 = Mesh(devs, ("x",)), Mesh(devs.reshape(2, 2), ("x", "y"))
    rng = np.random.default_rng(1)
    arrays = {"rows": (rng.standard_normal((8, 6)), P("x"), mesh1),
              "grid": (rng.standard_normal((4, 6, 3)), P("x", "y"), mesh2)}
    params = {k: jax.device_put(jnp.asarray(a, jnp.float32),
                                NamedSharding(m, spec))
              for k, (a, spec, m) in arrays.items()}
    path = _save_state(tmp_path / "ckp", 1, params, optax.sgd(0.1, 0.9))
    store = ocdbt.OcdbtStore(path)
    for name in ("rows", "grid"):
        chunks = [k for k in store.list(f"params.{name}/".encode())
                  if not k.endswith(b".zarray")]
        assert len(chunks) == 4, (name, chunks)
    got = orbax_read.restore(path)
    assert_same_tree(orbax_restore(path), got)
    for k, (a, _, _) in arrays.items():
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      a.astype(np.float32))


def _ts_array(db, name, data, chunks, **meta):
    """`data` written by tensorstore's zarr driver into the OCDBT
    database `db` under `name/`."""
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{db}/",
                        "path": f"{name}/"},
            "metadata": {"dtype": meta.pop("dtype", data.dtype.str),
                         "shape": list(data.shape), "chunks": list(chunks),
                         "compressor": meta.pop("compressor",
                                                {"id": "zstd", "level": 3}),
                         **meta},
            "create": True, "delete_existing": True}
    arr = ts.open(spec).result()
    return arr


def _metadata_for(db, names):
    """A _METADATA naming each array as a dict leaf."""
    tree = {str((n,)): {"key_metadata": [{"key": n, "key_type": 2}],
                        "value_metadata": {"value_type": "np.ndarray",
                                           "skip_deserialize": False}}
            for n in names}
    with open(db / "_METADATA", "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True,
                   "use_zarr3": False}, f)


def test_zarr_layouts_against_tensorstore(tmp_path):
    """Layouts orbax does not write but zarr v2 allows, read as
    tensorstore reads them: '/' chunk keys, F order, a fill value for
    chunks never written, edge chunks, big-endian and bfloat16 data,
    bool, int64 and float64."""
    db = tmp_path / "db"
    rng = np.random.default_rng(2)
    cases = {
        "slash": (rng.standard_normal((7, 5, 4)), (3, 2, 4),
                  {"dimension_separator": "/"}),
        "fortran": (rng.integers(-2 ** 40, 2 ** 40, (6, 5)), (4, 2),
                    {"order": "F"}),
        "big_endian": (rng.standard_normal((9,)).astype(">f4"), (4,), {}),
        "flags": (rng.random((5, 3)) < 0.5, (2, 2), {}),
        "bf16": (np.asarray(jnp.asarray(rng.standard_normal((6, 4)),
                                        jnp.bfloat16)), (4, 4),
                 {"dtype": "bfloat16"}),
        "filled": (np.full((8, 8), 7.5), (4, 4), {"fill_value": 7.5}),
        "raw": (rng.integers(0, 255, (5, 5)).astype(np.uint8), (2, 3),
                {"compressor": None}),
    }
    want = {}
    for name, (data, chunks, meta) in cases.items():
        arr = _ts_array(db, name, data, chunks, **dict(meta))
        if name == "filled":
            arr[0:4, 4:8] = np.arange(16.0).reshape(4, 4)   # one chunk
        else:
            arr[...] = data
        want[name] = arr.read().result()
    _metadata_for(db, cases)
    got = orbax_read.restore(db)
    for name, w in want.items():
        assert_same_tree(w, got[name], name)
    store = ocdbt.OcdbtStore(db)
    assert store.list(b"slash/0/0/0") == [b"slash/0/0/0"]
    assert len([k for k in store.list(b"filled/")
                if not k.endswith(b".zarray")]) == 1


def test_unsupported_layouts_raise(tmp_path):
    """zarr v3, a save without OCDBT, another compressor, no _METADATA:
    NotImplementedError naming it, from restore and from the entry
    points; corrupt chunks and missing array metadata: ValueError."""
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    for name, kw, match in (("z3", dict(use_zarr3=True), "zarr v3"),
                            ("nooc", dict(use_ocdbt=False), "without OCDBT")):
        path = tmp_path / name / "ckpt_000001"
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**kw)).save(
            str(path), args=ocp.args.PyTreeSave(tree))
        assert orbax_read.is_orbax_dir(path)
        with pytest.raises(NotImplementedError, match=match):
            orbax_read.restore(path)
        with pytest.raises(NotImplementedError, match=match):
            Inferencer(AttrDict.from_nested(serve_cfg()),
                       ckpt_path=str(tmp_path / name), device="cpu")
    db = tmp_path / "zlib"
    _ts_array(db, "w", np.ones((4, 4), np.float32), (4, 4),
              compressor={"id": "zlib", "level": 1})[...] = 1.0
    _metadata_for(db, ["w"])
    with pytest.raises(NotImplementedError, match="compressor 'zlib'"):
        orbax_read.restore(db)
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="_METADATA"):
        orbax_read.restore(bare)

    jcfg, jm = jbuild(JAttrDict.from_nested(serve_cfg()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 16, 1)))
    path = Path(_save_state(tmp_path / "ckp", 1, params, optax.sgd(0.1)))
    store = ocdbt.OcdbtStore(path)
    chunks = store.read_many(k for k in store.list(b"params.")
                             if not k.endswith(b".zarray"))
    key = max(chunks, key=lambda k: len(chunks[k]))   # stored out of line
    frame = chunks[key]
    # the chunk's bytes in its data file, zeroed after its first 20: a
    # corrupt zstd frame
    for f in (store.root / "ocdbt.process_0" / "d").iterdir():
        raw = f.read_bytes()
        at = raw.find(frame)
        if at >= 0:
            f.write_bytes(raw[:at + 20] + bytes(len(frame) - 20)
                          + raw[at + len(frame):])
    with pytest.raises(ValueError, match=key.decode().split("/")[0]):
        orbax_read.restore(path, ("params",))
    meta = json.loads((path / "_METADATA").read_text())
    meta["tree_metadata"][str(("params", "nothing"))] = {
        "key_metadata": [{"key": "params", "key_type": 2},
                         {"key": "nothing", "key_type": 2}],
        "value_metadata": {"value_type": "jax.Array",
                           "skip_deserialize": False}}
    (path / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="no params.nothing/.zarray"):
        orbax_read.restore(path, ("params", "nothing"))


# ------------------------------------------------------------ serving

def _record_reads(monkeypatch):
    asked = []
    real = ocdbt.OcdbtStore.read_many

    def read_many(self, keys):
        keys = list(keys)
        asked.extend(keys)
        return real(self, keys)

    monkeypatch.setattr(ocdbt.OcdbtStore, "read_many", read_many)
    monkeypatch.setattr(ocdbt.OcdbtStore, "read", lambda *a: pytest.fail(
        "a single-key read"))
    return asked


def test_inferencer_serves_an_orbax_dir_as_jax_does(tmp_path, monkeypatch):
    """A JAX TrainState (fp32 params, AdamW) saved into ckp/: both
    Inferencers at fp64 from the ckp/ root (its newest step) agree within
    F64_ATOL; the port reads nothing but params keys, never a moment."""
    jcfg, jm = jbuild(JAttrDict.from_nested(serve_cfg()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(4),
                              jnp.zeros((1, 16, 16, 16, 1)))
    ckp = tmp_path / "ckp"
    _save_state(ckp, 2, params, optax.adamw(1e-3))
    _save_state(ckp, 10, params, optax.adamw(1e-3))   # the newest
    shutil.rmtree(ckp / "ckpt_000002" / "d")          # older: unreadable
    vol = np.random.default_rng(5).random((24, 28, 20))
    with x64():
        j = japi.Inferencer(JAttrDict.from_nested(serve_cfg()),
                            ckpt_path=str(ckp), compute_dtype=jnp.float64)
        want = {k: np.asarray(v) for k, v in
                j.evaluate_image(vol, keep_feat=False).items()}
    asked = _record_reads(monkeypatch)
    t = Inferencer(AttrDict.from_nested(serve_cfg()), ckpt_path=str(ckp),
                   compute_dtype=torch.float64, device="cpu")
    assert asked and all(k.startswith(b"params.") for k in asked), [
        k for k in asked if not k.startswith(b"params.")][:3]
    got = t.evaluate_image(vol, keep_feat=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=F64_ATOL,
                                   err_msg=k)


def pair_cfg(load):
    cfg = joint_cfg(load, f_maps=8, num_levels=3, size=(16, 16, 16),
                    gen="twostage", train="twostage")
    cfg.unit_feat = False
    return cfg


def test_twostage_inferencer_reads_one_orbax_state(tmp_path, monkeypatch):
    """One TrainState with params {pathol, task}: each stage takes its
    part; the port reads the directory once for both stages and serves as
    the JAX TwoStageInferencer does at fp64."""
    jcfg, pm, tm = jinpaint(pair_cfg(jload))
    x = jnp.zeros((1, 16, 16, 16, 1))
    r1, r2 = jax.random.split(jax.random.PRNGKey(6))
    params = {"pathol": pm.init(r1, x),
              "task": tm.init(r2, x, cond=jnp.zeros_like(x))}
    path = _save_state(tmp_path / "ckp", 1, params, optax.adamw(1e-3))
    vol = np.random.default_rng(7).random((16, 16, 16))
    with x64():
        j = japi.TwoStageInferencer(pair_cfg(jload), pathol_ckpt=path,
                                    task_ckpt=path,
                                    compute_dtype=jnp.float64)
        want = {k: np.asarray(v) for k, v in j.evaluate_image(vol).items()
                if not k.startswith("feat")}
    calls = []
    real = orbax_read.restore
    monkeypatch.setattr(orbax_read, "restore",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    t = TwoStageInferencer(pair_cfg(tload), pathol_ckpt=path,
                           task_ckpt=path, compute_dtype=torch.float64,
                           device="cpu")
    assert len(calls) == 1
    got = t.evaluate_image(vol, keep_feat=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=F64_ATOL,
                                   err_msg=k)


def test_missing_checkpoints_raise_as_in_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    for p in (tmp_path / "empty", tmp_path / "absent"):
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            Inferencer(AttrDict.from_nested(serve_cfg()), ckpt_path=str(p),
                       device="cpu")
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            TwoStageInferencer(pair_cfg(tload), pathol_ckpt=str(p),
                               device="cpu")


# ------------------------------------------------------------ training

def test_resumed_step_matches_the_jax_step(tmp_path):
    """JAX: one AdamW step from init (s1), saved by save_checkpoint at
    fp64, then a second step (s2). Port: load_checkpoint of s1 (params,
    moments, count, step) then one step on the same batch equals s2:
    metrics rtol 1e-10, params rel-L2 1e-9 per tensor."""
    over = {"optimizer": "adamw", "lr": LR, "weight_decay": WD,
            "clip_max_norm": 0.0}
    with x64():
        cfg = joint_cfg(jload)
        cfg.update(over)
        jcfg, jm = jbuild(cfg, compute_dtype=jnp.float64)
        x = jnp.zeros((1, *jcfg.generator.size, 1), jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              jax.jit(jm.init)(jax.random.PRNGKey(0), x))
        _, jw, jfn = jcriterion(jcfg)
        batch = np_batch(0, jcfg.n_labels)
        opt = jstep.build_optimizer(jcfg)

        def loss(p, b):
            def per_item(s, t):
                return jfn(japply(jm.apply(p, s["input"]), jcfg), t, s)

            ls = jax.vmap(per_item)(b["samples"], b["targets"])
            ls = {k: jnp.mean(v) for k, v in ls.items()}
            return jweighted(ls, jw), ls

        vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
        update = jax.jit(lambda s, t, ls, g: jstep._finite_update(
            s, opt, t, ls, g, LR, WD))

        def jstep_(state):
            (t, ls), g = vg(state.params, to_jax(batch))
            return update(state, t, ls, g)

        s0 = jstep.TrainState(params, opt.init(params),
                              jnp.zeros((), jnp.int32))
        s1, _ = jstep_(s0)
        path = jsave(str(tmp_path / "ckp"), 1, s1, extra={"epoch": 0})
        assert_same_tree(orbax_restore(path), orbax_read.restore(path))
        s2, m2 = jstep_(s1)
    pcfg = joint_cfg(tload)
    pcfg.update(over)
    pcfg, model = build_model(pcfg, device="cpu")
    model = model.double()
    state = ckpt.load_checkpoint(path, TrainState(
        model, build_optimizer(pcfg, model.parameters()), 0))
    assert state.step == 1
    _, w, loss_fn = make_criterion(pcfg)
    step = make_train_step(model, pcfg, w, loss_fn, state.optimizer,
                           amp=False)
    state, pm = step(state, to_torch(batch), LR, WD)
    assert state.step == 2 and set(pm) == set(m2)
    for k in m2:
        np.testing.assert_allclose(float(pm[k]), float(m2[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want, got = jax_params_as_port(s2.params), port_params(state.model)
    for k in want:
        assert rel_l2(got[k], want[k]) < PARAM_REL_L2, k


def _small_bank():
    bank = SubjectBank((24, 24, 24))
    bank.add_debug_subject(seed=0, extent=(20, 22, 20))
    bank.add_debug_subject(seed=1, extent=(22, 20, 21))
    return bank


@pytest.mark.parametrize("extra", [True, False])
def test_train_resumes_a_jax_run(tmp_path, extra):
    """train(resume=<orbax dir>): a JAX run's checkpoint at step 2 (one
    epoch of 2 iterations) continues at epoch 1, from extra.json's epoch
    or, without it, step // itr_per_epoch, and ends at step 4."""
    jcfg, jm = jbuild(joint_cfg(jload, size=(16, 16, 16)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(8),
                              jnp.zeros((1, 16, 16, 16, 1)))
    path = _save_state(tmp_path / "jax", 2, params,
                       jstep.build_optimizer(jcfg),
                       extra={"epoch": 0} if extra else None)
    cfg = joint_cfg(tload, size=(16, 16, 16))
    cfg.n_epochs, cfg.remat = 2, False
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device="cpu")
    _, w, fn = make_criterion(cfg)
    state = loop.train(cfg, model, w, fn, _small_bank(),
                       str(tmp_path / "port"), itr_per_epoch=2,
                       n_val_items=1, log_itr=1, resume=path)
    assert state.step == 4
    lines = [json.loads(s) for s in open(tmp_path / "port" / "log.txt")]
    assert [s["epoch"] for s in lines] == [1]
    assert ckpt.latest_checkpoint(str(tmp_path / "port" / "ckp")).endswith(
        "ckpt_000004")


def test_fsdp_load_checkpoint_of_a_jax_run(tmp_path):
    """Two gloo ranks, data=2 FSDP: load_checkpoint of a JAX TrainState
    (random AdamW moments, count and step 1) shards the params and the
    optax moments; gathered, they equal one process's load bitwise."""
    jcfg, jm = jbuild(joint_cfg(jload, size=(16, 16, 16)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(10),
                              jnp.zeros((1, 16, 16, 16, 1)))
    opt_state = fixtures._random_moments(
        optax.adamw(1e-3).init(params), np.random.default_rng(11), 1)
    jsave(str(tmp_path / "jax"), 1, jstep.TrainState(
        params, opt_state, jnp.asarray(1, jnp.int32)))
    handle = td.spawn("fsdp_orbax", 2, tmp_path)
    cfg, model = td._small_model(seed=9)
    cfg.optimizer = "adamw"
    st = ckpt.load_checkpoint(
        str(tmp_path / "jax" / "ckpt_000001"),
        TrainState(model, build_optimizer(cfg, model.parameters()), 0))
    want_opt = st.optimizer.state_dict()["state"]
    assert st.step == 1 and want_opt
    for r in td.collect(handle):
        assert r["step"] == 1
        for k, v in model.state_dict().items():
            assert torch.equal(r["params"][k], v), k
        assert set(r["opt"]) == set(want_opt)
        for i, s in want_opt.items():
            for kk, vv in s.items():
                assert torch.equal(torch.as_tensor(r["opt"][i][kk]),
                                   torch.as_tensor(vv)), (i, kk)


def test_latest_and_resolve_find_orbax_step_dirs(tmp_path):
    """A ckp/ root holding orbax and port step directories: the newest by
    number, whichever format; a tmp directory of an unfinished orbax save
    is passed over."""
    jcfg, jm = jbuild(JAttrDict.from_nested(serve_cfg()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 16, 1)))
    root = tmp_path / "ckp"
    newest = _save_state(root, 12, params, optax.sgd(0.1))
    _save_state(root, 3, params, optax.sgd(0.1))
    (root / "ckpt_000099.orbax-checkpoint-tmp-1").mkdir()
    assert ckpt.latest_checkpoint(str(root)) == newest
    assert ckpt.resolve_checkpoint(str(root)) == newest
    assert ckpt.resolve_checkpoint(newest) == newest


# ------------------------------------------------------------ fixtures

@pytest.mark.parametrize("name", ["small", "twostage", "flagship"])
def test_committed_fixtures_read_alike(name):
    """tests/fixtures/torch_orbax (tests/_torch_orbax_fixtures.py): the
    port's restore of each committed checkpoint equals orbax's, subtree
    by subtree."""
    path = ckpt.resolve_checkpoint(os.path.join(fixtures.OUT, name))
    want = orbax_restore(path)
    for top in want:
        assert_same_tree(want[top], orbax_read.restore(path, (top,)), top)
    if name == "small":
        adam = find_state(want["opt_state"], ("count", "mu", "nu"))
        assert int(adam["count"]) == int(want["step"]) == fixtures.SMALL_STEP
