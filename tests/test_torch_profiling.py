"""The program's spans and counters (brainfm_tpu_torch/utils/profiling.py):
off they record and allocate nothing; on (`recording()` or a
torch.profiler session) they nest per thread, share their unit's id, read
`time.time_ns()`; a tiny generator item, train step and served volume
record the named spans and counts; `trace()` writes them into its Chrome
trace. The card-only tests (`-m cuda`) hold `host_syncs` to
`torch.cuda.set_sync_debug_mode("warn")` and check that no span or counter
synchronizes. This file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py -q
"""

import json
import os
import threading
import time
import traceback
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from brainfm_tpu_torch.config import AttrDict
from brainfm_tpu_torch.infer.api import Inferencer, TwoStageInferencer
from brainfm_tpu_torch.models import build_model
from brainfm_tpu_torch.models.criterion import make_criterion
from brainfm_tpu_torch.scripts.train import train_config
from brainfm_tpu_torch.synth import (SubjectBank, SynthStatic, knobs_from_cfg,
                                     synth_item)
from brainfm_tpu_torch.synth.batch import stack_items
from brainfm_tpu_torch.train.step import (TrainState, build_optimizer,
                                          make_train_step)
from brainfm_tpu_torch.utils import nifti, profiling
from brainfm_tpu_torch.utils.profiling import annotate, count, recording

GEN = ("gen.item", "gen.setup", "gen.deform", "gen.synth", "gen.targets",
       "gen.pathology", "gen.shape", "gen.advect", "gen.sample")
STEP = ("step", "step.forward", "step.backward", "step.check",
        "step.update")
VOLUME = ["serve.read", "serve.prepare", "serve.forward", "serve.fetch",
          "serve.write"]
# a pathology item: the setup draws that turn it on, from a random shape
PATHOLOGY_ON = {"setup": {"pathol_u": 0.0, "shape_u": 0.0}}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _names(spans):
    return [s.name for s in spans]


# ------------------------------------------------------------- the switch

def test_off_records_and_allocates_nothing():
    with recording():
        with annotate("before"):
            count("before")
    spans, counts = list(profiling.SPANS), dict(profiling.COUNTS)
    assert annotate("x") is profiling.OFF
    assert profiling.within(profiling.OFF) is profiling.OFF
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(1000):
            with annotate("x", unit=True):
                count("host_syncs")
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, profiling.__file__)]
    grown = snap1.filter_traces(here).compare_to(
        snap0.filter_traces(here), "lineno")
    assert sum(d.size_diff for d in grown) <= 0
    assert _names(profiling.SPANS) == _names(spans) == ["before"]
    assert profiling.COUNTS == counts == {"before": 1}


def test_recording_nests_and_shares_the_unit():
    with recording():
        with annotate("item", unit=True) as item:
            with annotate("stage") as stage:
                with annotate("leaf") as leaf:
                    count("n", 2)
            box = {}

            def worker():
                with profiling.within(item):
                    with annotate("on_thread") as s:
                        box["span"] = s
                with annotate("orphan") as s:
                    box["orphan"] = s

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        with annotate("item", unit=True) as item2:
            pass
        count("n")
    assert _names(profiling.SPANS) == ["item", "stage", "leaf", "on_thread",
                                       "orphan", "item"]
    assert stage.parent is item and leaf.parent is stage
    assert item.parent is None and item2.parent is None
    assert item.unit == stage.unit == leaf.unit == box["span"].unit
    assert item2.unit != item.unit and box["orphan"].unit is None
    assert box["span"].parent is item and box["orphan"].parent is None
    assert box["span"].tid != item.tid == stage.tid
    assert profiling.COUNTS == {"n": 3}
    assert [(name, n) for _, name, n in profiling.EVENTS] == [("n", 2),
                                                              ("n", 1)]
    for s in profiling.SPANS:
        assert s.t0 <= s.t1
    assert item.t0 <= stage.t0 <= leaf.t0 <= leaf.t1 <= stage.t1 <= item.t1


def test_threads_lose_no_count_or_span():
    """More threads than cores, switching often: every count and span of
    every thread is kept, each span parented on its own thread."""
    import sys

    threads, reps = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            def work():
                for _ in range(reps):
                    with annotate("outer", unit=True) as o:
                        with annotate("inner") as i:
                            count("n")
                            count("m", 2)
                        assert i.parent is o

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.COUNTS == {"n": threads * reps, "m": 2 * threads * reps}
    assert len(profiling.EVENTS) == 2 * threads * reps
    assert len(profiling.SPANS) == 2 * threads * reps
    inner = [s for s in profiling.SPANS if s.name == "inner"]
    assert all(s.parent.name == "outer" and s.parent.tid == s.tid
               and s.unit == s.parent.unit for s in inner)
    assert len({s.unit for s in inner}) == threads * reps


def test_a_span_that_another_thread_closes():
    with recording():
        vol = annotate("volume", unit=True).open()
        t = threading.Thread(target=vol.close)
        t.start()
        t.join()
        with annotate("after") as after:
            pass
    assert vol.t1 is not None and vol.t0 <= vol.t1
    assert after.parent is None   # open() does not make it the parent


def test_spans_read_time_ns():
    with recording():
        a = time.time_ns()
        with annotate("x") as s:
            b = time.time_ns()
        c = time.time_ns()
    assert a <= s.t0 <= b <= s.t1 <= c


def test_recording_starts_clear():
    with recording():
        count("a")
    with recording():
        count("b")
    assert profiling.COUNTS == {"b": 1}
    with recording():
        count("c")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            count("d")
    assert profiling.COUNTS == {"d": 1}


def test_a_profiler_session_switches_recording_on():
    from torch.profiler import ProfilerActivity, profile

    box = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("main") as main:
            count("c")

        def worker():
            box["span"] = annotate("thread")
            with box["span"]:
                count("c")

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert annotate("x") is profiling.OFF
    count("c")
    assert _names(profiling.SPANS) == ["main", "thread"]
    assert box["span"] is not profiling.OFF and box["span"].parent is None
    assert main.parent is None and profiling.COUNTS == {"c": 2}
    # on, a span is also a record_function range of the CPU trace
    assert "main" in {e.name for e in prof.events()}


# ----------------------------------------------------- the program's spans

def _tiny_train(device, gen="shape_id"):
    """A generator (shape_id's: pathology, dopri5; brain_id's: the
    flagship's eight tasks) under the joint step, cut to 16^3, f_maps 8, 2
    levels, fp32."""
    cfg = train_config(gen, "joint")
    cfg.f_maps, cfg.num_levels, cfg.task_f_maps = 8, 2, [8]
    cfg.generator.size = [16, 16, 16]
    cfg.amp = False
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=device)
    scfg = SynthStatic.from_cfg(cfg)
    bank = SubjectBank((24, 24, 24))
    bank.add_debug_subject(seed=0, extent=(20, 20, 20))
    subj = bank.to_device(0, device)
    knobs = knobs_from_cfg(cfg, scfg, "synth")
    _, wdict, loss_fn = make_criterion(cfg)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, wdict, loss_fn, opt)
    state = TrainState(model, opt, 0)

    def iteration(seed, draws=PATHOLOGY_ON):
        nonlocal state
        t, s = synth_item(torch.Generator(device).manual_seed(seed), subj,
                          scfg, cfg.tasks, "synth", knobs, draws=draws)
        state, m = step(state, stack_items([t], [s]), 1e-4, 0.0)
        return m

    return iteration


def test_item_and_step_record_their_spans_and_counts():
    iteration = _tiny_train("cpu")
    with recording():
        iteration(3)
    spans = profiling.SPANS
    assert set(_names(spans)) == set(GEN + STEP)
    item = next(s for s in spans if s.name == "gen.item")
    gen = [s for s in spans if s.name.startswith("gen.")]
    assert all(s.unit == item.unit is not None for s in gen)
    assert {s.name for s in gen if s.parent is item} == {
        "gen.setup", "gen.deform", "gen.synth", "gen.targets", "gen.sample"}
    path = next(s for s in spans if s.name == "gen.pathology")
    assert path.parent.name == "gen.targets"
    assert {s.name for s in spans if s.parent is path} == {"gen.shape",
                                                           "gen.advect"}
    step = next(s for s in spans if s.name == "step")
    assert step.unit is None and step.parent is None
    assert [s.name for s in spans if s.parent is step] == list(STEP[1:])
    c = profiling.COUNTS
    assert c["ode.steps"] > 0 and c["ode.evals"] >= 1 + 6 * c["ode.steps"]
    assert c["ode.nt"] > 1 and c.get("ode.rejected", 0) >= 0
    # one read of the error ratio per adaptive step, besides the others
    assert c["host_syncs"] > c["ode.steps"]


def _tiny_inferencer(device, pair=False):
    """One UNet3D with T1 and segmentation heads, or with `pair` the
    two-stage pair (its stage 0 the pathology head) served alike."""
    tasks = ("T1", "segmentation") + (("pathology",) if pair else ())
    cfg = dict(task={t: True for t in tasks},
               generator={"size": [24, 24, 24]}, losses={"uncertainty": None},
               backbone="unet3d+unet3d" if pair else "unet3d", f_maps=8,
               num_levels=2, num_groups=8, layer_order="gcl",
               unit_feat=False, task_f_maps=[8])
    cls = TwoStageInferencer if pair else Inferencer
    return cls(AttrDict.from_nested(cfg), device=device)


def _heads(tmp_path, n):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"head{i}.nii.gz")
        nifti.save_nifti(p, rng.random((20, 26, 22), dtype=np.float32),
                         np.diag([1.0, 1.2, 1.0, 1.0]))
        paths.append(p)
    return paths


def _volume_children(spans, vol):
    """Every span under `vol`, in opening order."""
    def under(s):
        while s is not None:
            if s is vol:
                return True
            s = s.parent
        return False
    return [s for s in spans if s is not vol and under(s.parent)]


@pytest.mark.parametrize("prefetch", [False, True])
def test_evaluate_path_records_each_volume(tmp_path, prefetch):
    inf = _tiny_inferencer("cpu")
    paths = _heads(tmp_path, 2)
    with recording():
        inf.evaluate_path(paths, str(tmp_path / "out"), win_size=(24,) * 3,
                          exclude_keys=("T1",), prefetch=prefetch)
    vols = [s for s in profiling.SPANS if s.name == "serve.volume"]
    assert len(vols) == 2 and vols[0].unit != vols[1].unit
    for vol in vols:
        kids = _volume_children(profiling.SPANS, vol)
        assert sorted(_names(kids), key=VOLUME.index) == VOLUME
        assert all(k.parent is vol and k.unit == vol.unit for k in kids)
        assert all(vol.t0 <= k.t0 <= k.t1 <= vol.t1 for k in kids)
        if not prefetch:
            assert _names(kids) == VOLUME
            assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    if prefetch:   # the reads and writes ran on the pool's threads
        read = [s for s in profiling.SPANS if s.name == "serve.read"]
        assert read[0].tid != vols[0].tid
    else:
        assert all(s.tid == vols[0].tid for s in profiling.SPANS
                   if s.name != "serve.write")
    assert profiling.COUNTS["host_syncs"] > 0


def test_twostage_stages_nest_inside_serve_forward(tmp_path):
    inf = _tiny_inferencer("cpu", pair=True)
    (path,) = _heads(tmp_path, 1)
    with recording():
        inf.evaluate_path([path], str(tmp_path / "on"), win_size=(24,) * 3)
    spans = list(profiling.SPANS)
    fwd = next(s for s in spans if s.name == "serve.forward")
    stages = [s for s in spans if s.name.startswith("serve.stage")]
    assert _names(stages) == ["serve.stage0", "serve.stage1"]
    assert all(s.parent is fwd and s.unit == fwd.unit for s in stages)
    assert fwd.t0 <= stages[0].t0 <= stages[0].t1 <= stages[1].t0 \
        <= stages[1].t1 <= fwd.t1
    assert all(s.device_ms() is None for s in stages)   # no card here
    inf.evaluate_path([path], str(tmp_path / "off"), win_size=(24,) * 3)
    assert profiling.SPANS == spans


def test_a_twostage_volume_counts_the_host_syncs_of_one_model(tmp_path):
    (path,) = _heads(tmp_path, 1)
    counted = []
    for pair in (False, True):
        inf = _tiny_inferencer("cpu", pair=pair)
        with recording():
            inf.evaluate_path([path], str(tmp_path / str(pair)),
                              win_size=(24,) * 3)
        counted.append(profiling.COUNTS["host_syncs"])
    assert counted[0] == counted[1] > 0


@pytest.mark.parametrize("name,depth,chunks", [
    ("many.nii.gz", 37, 13), ("one.nii.gz", 3, 0), ("many.nii", 37, 0)])
def test_write_chunks_counts_the_pool_chunks(tmp_path, monkeypatch, name,
                                             depth, chunks):
    """`write.chunks`: the chunks a .nii.gz deflated on the pool (here
    three 40x48 float32 planes each, the last chunk partial)."""
    monkeypatch.setattr(nifti, "CHUNK_BYTES", 3 * 40 * 48 * 4)
    with recording():
        nifti.save_nifti(str(tmp_path / name),
                         np.ones((40, 48, depth), np.float32))
    assert profiling.COUNTS.get("write.chunks", 0) == chunks


def test_trace_writes_the_spans_and_counters(tmp_path):
    log = str(tmp_path / "trace")
    with profiling.trace(log):
        with annotate("outer", unit=True):
            with annotate("inner"):
                torch.randn(64, 64) @ torch.randn(64, 64)
                count("host_syncs", 3)
            count("host_syncs")
    (name,) = os.listdir(log)
    with open(os.path.join(log, name)) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    prog = {e["name"]: e for e in ev if e.get("cat") == "program"
            and e["ph"] == "X"}
    assert set(prog) == {"outer", "inner"}
    assert prog["inner"]["args"]["parent"] == prog["outer"]["args"]["span"]
    assert prog["inner"]["args"]["unit"] == prog["outer"]["args"]["unit"]
    assert [e["args"]["host_syncs"] for e in ev if e["ph"] == "C"
            and e.get("cat") == "program"] == [3, 4]
    # the trace's own range of the same name lies where the span lies
    ann = next(e for e in ev if e.get("cat") == "user_annotation"
               and e["name"] == "inner")
    assert abs(ann["ts"] - prog["inner"]["ts"]) < 1e3          # us
    assert abs(ann["dur"] - prog["inner"]["dur"]) < 1e3
    assert any(e.get("cat") == "user_annotation" and e["name"] == "outer"
               for e in ev)


# ------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


class _SyncWarnings:
    """The synchronizing calls that torch.cuda's sync debug mode reports
    in the block, on any thread: `n` of them made from the port (a frame
    of brainfm_tpu_torch on the stack), by `sites` (the port's innermost
    line: count), and `outside`, the rest by their innermost line (the
    test's or the harness's own calls)."""

    def __enter__(self):
        self.n, self.sites, self.outside = 0, {}, {}
        self._show = warnings.showwarning
        self._filters = warnings.catch_warnings()
        self._filters.__enter__()
        warnings.simplefilter("always")

        def show(message, *a, **k):
            if "synchronizing" not in str(message):
                self._show(message, *a, **k)
                return
            stack = [f for f in traceback.extract_stack()[:-1]
                     if os.path.basename(f.filename) != "warnings.py"]
            here = [f for f in stack
                    if f"{os.sep}brainfm_tpu_torch{os.sep}" in f.filename]
            f = (here or stack or [None])[-1]
            site = (f"{os.path.basename(f.filename)}:{f.lineno}"
                    if f is not None else "?")
            into = self.sites if here else self.outside
            into[site] = into.get(site, 0) + 1
            self.n += bool(here)

        warnings.showwarning = show
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = self._show
        self._filters.__exit__(*exc)
        return False


@pytest.mark.cuda
def test_a_span_encloses_its_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with annotate("matmul") as span:
            y = x @ x
            torch.cuda.synchronize()
    del y
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    assert kernels and span is not profiling.OFF
    for a, b in kernels:
        assert span.t0 <= a <= b <= span.t1


@pytest.mark.cuda
def test_host_syncs_count_every_synchronizing_call(dev, tmp_path):
    iteration = _tiny_train(dev)
    iteration(1)                       # first calls: cuDNN's choices
    flagship = _tiny_train(dev, "brain_id")
    flagship(1, draws=None)
    inf = _tiny_inferencer(dev)
    paths = _heads(tmp_path, 2)
    inf.evaluate_path(paths[:1], str(tmp_path / "warm"), win_size=(24,) * 3)
    missed = {}
    for what, run in (
            ("pathology iteration", lambda: iteration(2)),
            ("fresh draws iteration", lambda: iteration(3, draws=None)),
            ("flagship iteration", lambda: flagship(2, draws=None)),
            ("served volume", lambda: inf.evaluate_path(
                paths[1:], str(tmp_path / "one"), win_size=(24,) * 3)),
            ("served volumes, prefetch", lambda: inf.evaluate_path(
                paths, str(tmp_path / "two"), win_size=(24,) * 3))):
        with recording(), _SyncWarnings() as w:
            run()
        counted = profiling.COUNTS.get("host_syncs", 0)
        if counted != w.n:
            missed[what] = (counted, w.n, w.sites, w.outside)
    assert not missed, missed


@pytest.mark.cuda
def test_spans_and_counters_do_not_synchronize(dev):
    """The same spans and counts around device work raise nothing under
    sync debug mode "error", with recording off, under `recording()` and
    inside a CUDA profiler session (whose own exit synchronizes, outside
    the checked block)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device=dev)

    def work():
        torch.cuda.set_sync_debug_mode("error")
        try:
            with annotate("a", unit=True):
                with annotate("b"):
                    y = x @ x
                    count("host_syncs")
            vol = annotate("v", unit=True).open()
            with profiling.within(vol):
                with annotate("c"):
                    y = y @ x
            vol.close()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    torch.cuda.synchronize()
    work()
    with recording():
        work()
    assert len(profiling.SPANS) == 4 and profiling.COUNTS == {
        "host_syncs": 1}
    with profile(activities=[ProfilerActivity.CUDA]):
        work()
    assert len(profiling.SPANS) == 4
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_stage_timing_does_not_synchronize(dev, tmp_path):
    """A served two-stage volume: the same host syncs as a one-model
    volume, each one counted, none from the stages' device timing (sync
    debug mode "warn"); a device-timed span raises nothing under "error".
    The timings resolve after the window."""
    paths = _heads(tmp_path, 2)
    one, pair = _tiny_inferencer(dev), _tiny_inferencer(dev, pair=True)
    syncs = []
    for inf in (one, pair):
        inf.evaluate_path(paths[:1], str(tmp_path / "warm"),
                          win_size=(24,) * 3)
        with recording(), _SyncWarnings() as w:
            inf.evaluate_path(paths[1:], str(tmp_path / "one"),
                              win_size=(24,) * 3)
        counted = profiling.COUNTS.get("host_syncs", 0)
        assert counted == w.n, (counted, w.n, w.sites, w.outside)
        syncs.append(counted)
    assert syncs[0] == syncs[1] > 0
    stages = [s for s in profiling.SPANS if s.name.startswith("serve.stage")]
    assert _names(stages) == ["serve.stage0", "serve.stage1"]
    assert all(s.device_ms() > 0 for s in stages)

    x = torch.randn(512, 512, device=dev)
    torch.cuda.synchronize()
    with recording():
        torch.cuda.set_sync_debug_mode("error")
        try:
            with annotate("timed", device=dev) as span:
                y = x @ x
        finally:
            torch.cuda.set_sync_debug_mode(0)
    del y
    assert span.device_ms() > 0
