"""The public names of the JAX package and the repo's programs resolve in
their twins in the port, and the names added last equal their JAX
counterparts: `config.preprocess_cfg` and `to_namespace`,
`runtime.build_native` and `native_available`, and the label lists of
`models.build`."""

import ast
import importlib
import os
import shutil
from types import SimpleNamespace

import pytest

import brainfm_tpu.config as jax_config
import brainfm_tpu.models.build as jax_build
from brainfm_tpu_torch import config as port_config
from brainfm_tpu_torch import runtime as port_runtime
from brainfm_tpu_torch.models import build as port_build
from brainfm_tpu_torch.runtime import loader, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(ROOT, "cfgs")

# names of a JAX module with no counterpart in its twin, and why
NO_TWIN = {
    # the JAX package's lax.scan walk over the tiles; the port has one
    # loop with fp32 canvases (ROADMAP, kept divergences: infer/tiles.py)
    ("brainfm_tpu/infer/tiles.py", "make_tiled_fused"),
    ("brainfm_tpu/infer/tiles.py", "tiled_apply_fused"),
    # the root bench's script state and helpers; the port's bench keeps
    # them on its `Bench` object (`summary`, `emit_contract`, `log`)
    ("bench.py", "COLD_CACHE"), ("bench.py", "SMOKE"),
    ("bench.py", "T_START"), ("bench.py", "emit_contract"),
    ("bench.py", "finalize"), ("bench.py", "log_ts"),
}
# JAX modules with no twin at all: the Pallas kernels and their router
# (CUDA C++ in csrc/), the torch-to-flax importer (the port's names are
# the reference's) and XLA's compile cache
NO_MODULE = {"brainfm_tpu/ops/pallas_lut.py",
             "brainfm_tpu/ops/pallas_warp_blocks.py",
             "brainfm_tpu/ops/warp_auto.py",
             "brainfm_tpu/models/torch_import.py",
             "brainfm_tpu/utils/cache.py"}


def _pairs():
    """(JAX source file, twin module) for every JAX module with a twin:
    the package's modules, the driver contract, the bench and the
    scripts."""
    out = []
    for dp, _, files in os.walk(os.path.join(ROOT, "brainfm_tpu")):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dp, f), ROOT)
            if rel in NO_MODULE:
                continue
            mod = "brainfm_tpu_torch" + rel[len("brainfm_tpu"):-3].replace(
                os.sep, ".")
            out.append((rel, mod.removesuffix(".__init__")))
    out += [("__graft_entry__.py", "brainfm_tpu_torch.entry"),
            ("bench.py", "brainfm_tpu_torch.bench")]
    for f in sorted(os.listdir(os.path.join(ROOT, "scripts"))):
        if os.path.isfile(os.path.join(ROOT, "brainfm_tpu_torch", "scripts",
                                       f)):
            out.append((f"scripts/{f}",
                        f"brainfm_tpu_torch.scripts.{f[:-3]}"))
    return out


def _public_names(path):
    names = set()
    for n in ast.parse(open(os.path.join(ROOT, path)).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_resolves_in_its_twin():
    pairs = _pairs()
    assert ("scripts/profile_train.py",
            "brainfm_tpu_torch.scripts.profile_train") in pairs
    for path in NO_MODULE:
        assert os.path.isfile(os.path.join(ROOT, path)), path
    missing = []
    for path, mod in pairs:
        twin = importlib.import_module(mod)
        missing += [(path, n) for n in sorted(_public_names(path))
                    if not hasattr(twin, n) and (path, n) not in NO_TWIN]
    assert missing == []
    # every exception is still a public name of its JAX module
    for path, n in NO_TWIN:
        assert n in _public_names(path), (path, n)
    for name in ("preprocess_cfg", "to_namespace"):
        assert name in port_config.__all__
    for name in ("build_native", "native_available"):
        assert name in port_runtime.__all__


def _yamls(kind):
    d = os.path.join(CFGS, kind)
    return sorted(os.path.relpath(os.path.join(dp, f), d)
                  for dp, _, fs in os.walk(d) for f in fs
                  if f.endswith(".yaml") and not f.startswith("default"))


@pytest.mark.parametrize("kind", ["trainer", "generator"])
def test_preprocess_cfg_equals_jax(kind):
    default = os.path.join(CFGS, kind, "default_train.yaml"
                           if kind == "trainer" else "default.yaml")
    files = _yamls(kind)
    assert len(files) >= 15
    for f in files:
        stem = os.path.splitext(f)[0]
        for args in (([default, f], os.path.join(CFGS, kind)),
                     ([default, os.path.basename(stem), None],
                      os.path.join(CFGS, kind, os.path.dirname(f)))):
            got = port_config.preprocess_cfg(*args)
            want = jax_config.preprocess_cfg(*args)
            assert got == want, f
            assert isinstance(got, port_config.AttrDict)


def test_to_namespace_nested():
    d = {"a": 1, "b": {"c": [1, {"d": "x"}, [2, {"e": None}]],
                       "f": {"g": 2.5}}, "h": []}
    got = port_config.to_namespace(d)
    want = jax_config.to_namespace(d)
    assert got == want
    assert isinstance(got, SimpleNamespace)
    assert got.b.c[1].d == "x" and got.b.c[2][1].e is None
    assert got.b.f.g == 2.5 and got.h == []
    assert port_config.to_namespace(3) == 3


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on this host")


@needs_gxx
def test_build_native_and_native_available():
    assert port_runtime.build_native() is True
    assert port_runtime.native_available() is True
    assert loader.library_path().exists()


@needs_gxx
def test_build_native_force_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    calls = []
    real = native.subprocess.run

    def run(cmd, *a, **k):
        calls.append(cmd[0])
        return real(cmd, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", run)
    assert loader.build_native() is True
    lib = loader.library_path()
    assert lib.parent == tmp_path and lib.exists()
    assert loader.build_native() is True      # built: no compile
    assert calls == ["g++"]
    first = lib.stat().st_mtime_ns
    assert loader.build_native(force=True) is True
    assert calls == ["g++", "g++"]
    assert lib.exists() and lib.stat().st_mtime_ns >= first


def test_build_native_fails_on_a_source_that_does_not_compile(
        tmp_path, monkeypatch, capsys):
    bad = tmp_path / "volcodec.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(loader, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert loader.build_native() is False
    assert "volcodec build" in capsys.readouterr().out
    assert not loader.library_path().exists()
    # the codec itself still raises on a failed build
    monkeypatch.setattr(loader, "_LIB", None)
    with pytest.raises(RuntimeError, match="volcodec build"):
        loader.VolCodec((4, 4, 4))


def test_build_native_fails_without_a_compiler(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def missing(cmd, *a, **k):
        raise FileNotFoundError(2, "No such file or directory", cmd[0])

    monkeypatch.setattr(native.subprocess, "run", missing)
    assert loader.build_native() is False
    assert "volcodec build" in capsys.readouterr().out


def test_model_build_label_lists_equal_jax():
    assert port_build.LABELS_LEFT == jax_build.LABELS_LEFT
    assert port_build.LABELS_EXTRACEREBRAL == jax_build.LABELS_EXTRACEREBRAL
    assert port_build.N_NEUTRAL_EXTRACEREBRAL == \
        jax_build.N_NEUTRAL_EXTRACEREBRAL == 20
    from brainfm_tpu_torch.synth import constants

    # one list, imported, not a second copy
    assert port_build.LABELS_LEFT is constants.LABELS_LEFT
    assert port_build.LABELS_EXTRACEREBRAL is constants.LABELS_EXTRACEREBRAL
