"""Mesh training and serving of the port on spawned gloo CPU ranks:
train(mesh=) with data=2 against one process (every step's loss at fp64,
1e-12), the training CLI with --mesh 2 launched as torchrun launches it
(one process per rank, RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT),
--fsdp without --mesh, and Inferencer(mesh=): evaluate_image on space=2
against one process (1e-10), evaluate_batch's check of the data axis and
evaluate_path(batch_size=2) over 3 files on data=2 writing the files one
process writes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brainfm_tpu_torch.infer import Inferencer
from brainfm_tpu_torch.scripts import train as train_script
from brainfm_tpu_torch.utils import nifti

import _torch_dist as td

LOSS_RTOL = 1e-12
SERVE_TOL = 1e-10


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    td._write_vols(str(tmp))
    return td.run("mesh_train", 2, tmp), tmp


def test_train_on_a_data_mesh_matches_one_process(ranks, tmp_path):
    """2 epochs x 2 iterations of 2 items from a subject bank: data rank r
    synthesizes item r of each batch from its own generator, the
    gradients are summed over the ranks; rank 0 writes the logs and
    checkpoints."""
    rs, tmp = ranks
    want = td.train_small(str(tmp_path / "single"))
    assert len(want) == 4
    for r in rs:
        np.testing.assert_allclose(r["steps"], want, rtol=LOSS_RTOL)
    run = os.path.join(tmp, "run")
    assert {"ckpt_000002", "ckpt_000004"} <= set(os.listdir(
        os.path.join(run, "ckp")))
    assert len(open(os.path.join(run, "log.txt")).readlines()) == 2


def test_run_directory_takes_rank0_time(ranks):
    """update_out_dir broadcasts rank 0's timestamp: one directory for
    ranks whose clocks read different seconds."""
    rs, _ = ranks
    assert rs[0]["out_dir"] == rs[1]["out_dir"]
    assert rs[0]["out_dir"].startswith(os.path.join("outs", "j-e-"))


def _single():
    return Inferencer(td.serve_cfg(), compute_dtype=torch.float64,
                      device="cpu")


def test_evaluate_image_on_a_space_mesh(ranks):
    """Each rank serves its D slab (40 -> 20, 10, 5 per level; the volume
    is (40, 36, 28)); the outputs and the last feature level, gathered
    whole, against one process."""
    rs, _ = ranks
    inf = _single()
    want = inf.evaluate_image(td.serve_volume())
    feat = inf.evaluate_image(td.serve_volume(), feature_only=True)
    for r in rs:
        got = r["image"]
        assert set(got) == {k for k in want if not k.startswith("feat")}
        for k, v in got.items():
            if v.is_floating_point():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=SERVE_TOL, atol=SERVE_TOL,
                                           err_msg=k)
            else:
                assert torch.equal(v, want[k]), k
        np.testing.assert_allclose(r["feat"].numpy(), feat.numpy(),
                                   rtol=SERVE_TOL, atol=SERVE_TOL)


def test_evaluate_batch_needs_a_multiple_of_the_data_axis(ranks):
    rs, _ = ranks
    for r in rs:
        assert r["batch_error"].startswith(
            "batch of 3 volumes cannot shard over the mesh 'data' axis of "
            "size 2")


def test_evaluate_path_on_a_data_mesh_writes_the_single_files(ranks):
    """Groups of 2 over 3 files (24^3, 40^3 cropped to 32^3, 24^3): the
    mixed first group runs as two buckets of one volume, each padded to
    the data axis; every file is written once, by the rank that served
    it, and equals the one-process file."""
    rs, tmp = ranks
    for r in rs:
        assert r["path_log"].count("evaluate_path: padding 1 volume(s) of "
                                   "shape") == 3, r["path_log"]
    paths = [os.path.join(tmp, f"vol{i}.nii.gz") for i in range(3)]
    single = os.path.join(tmp, "single_out")
    _single().evaluate_path(paths, single, win_size=(32, 32, 32),
                            exclude_keys=("segmentation",))
    mesh = os.path.join(tmp, "mesh_out")
    assert sorted(os.listdir(mesh)) == ["vol0", "vol1", "vol2"]
    for v in ("vol0", "vol1", "vol2"):
        files = sorted(os.listdir(os.path.join(single, v)))
        assert sorted(os.listdir(os.path.join(mesh, v))) == files
        assert "out_label.nii.gz" in files
        for f in files:
            a = nifti.load_nifti(os.path.join(mesh, v, f))[0]
            b = nifti.load_nifti(os.path.join(single, v, f))[0]
            np.testing.assert_allclose(a, b, rtol=SERVE_TOL, atol=SERVE_TOL,
                                       err_msg=f"{v}/{f}")


_CLI = ("import functools, sys; sys.path[:0] = [sys.argv[1]]; "
        "from brainfm_tpu_torch.scripts import train as t; "
        "from brainfm_tpu_torch.synth import datasets as d; "
        "t.build_datasets = functools.partial(d.build_datasets, "
        "bank_shape=(24, 24, 24), debug_extent=(22, 22, 22)); "
        "sys.exit(t.main(sys.argv[2:]))")


def _cli_cfgs(tmp_path):
    tr, gen = tmp_path / "tr.yaml", tmp_path / "gen.yaml"
    tr.write_text("job_name: cli\nf_maps: 8\nnum_levels: 2\n"
                  "task_f_maps: [8]\nremat: False\n")
    gen.write_text("generator:\n  size: [16, 16, 16]\n")
    return ["--train_cfg", str(tr), "--gen_cfg", str(gen), "--device", "cpu",
            "--debug", "--no_amp"]


def _launch(tmp_path, world, extra):
    """The CLI as torchrun launches it: `world` processes with RANK,
    LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT; returns their
    outputs (each must exit 0)."""
    port = td.free_port()
    out = tmp_path / "run"
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(PYTHONPATH="", OMP_NUM_THREADS="2", RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CLI, td.ROOT, *_cli_cfgs(tmp_path),
             *extra, "--out_dir", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=td.TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, t in zip(procs, texts):
        assert p.returncode == 0, t[-3000:]
    return texts


def test_cli_mesh_under_torchrun_env(tmp_path):
    """Two processes with torchrun's environment: one epoch of 2
    iterations of 2 items on the debug datasets' stream, each batch from
    one dataset (the grouped plan), each item on its own rank."""
    out = tmp_path / "run"
    for t in _launch(tmp_path, 2, ["--mesh", "2", "--batch_items", "2"]):
        assert "final step 2" in t
    assert (out / "ckp" / "ckpt_000002").is_dir()
    assert (out / "ckp" / "ckpt_best").is_dir()
    assert len((out / "log.txt").read_text().splitlines()) == 1


def test_cli_fresh_fsdp_run_in_fp32(tmp_path):
    """--mesh 1 --fsdp from scratch: the model built on the meta device
    and materialised shard by shard (init_sharded), trained at fp32 over
    gloo, its checkpoint gathered whole."""
    (t,) = _launch(tmp_path, 1, ["--mesh", "1", "--fsdp"])
    assert "final step 2" in t
    state = torch.load(tmp_path / "run" / "ckp" / "ckpt_000002" /
                       "model.pt", weights_only=True)
    assert not any(hasattr(v, "placements") for v in state.values())


def test_cli_fsdp_needs_a_mesh(tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_script.main([*_cli_cfgs(tmp_path), "--fsdp"])
    assert "--fsdp requires --mesh" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_script.main([*_cli_cfgs(tmp_path), "--mesh", "1", "--fsdp",
                           "--eval_only"])
