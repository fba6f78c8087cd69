"""chip_smoke.py's byte bound for K1 on the CPU: the distinct source voxels
that a warp reads, counted as a boolean scatter, against a brute-force set
count in numpy on a small grid with edge coordinates."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FLT_MIN = np.finfo(np.float32).tiny


def _grid(seed, out_shape, src_shape):
    rng = np.random.default_rng(seed)
    grid = []
    for a, n in enumerate(src_shape):
        c = rng.uniform(-1.5, n + 0.5, out_shape).astype(np.float32)
        hi = np.float32(n - 1)
        edges = np.array([0.0, hi, FLT_MIN, np.nextafter(FLT_MIN, np.float32(0)),
                          np.nextafter(hi, np.float32(n)), 0.5, hi - 0.5, 2.5],
                         np.float32)
        flat = c.reshape(-1)
        flat[a * len(edges):(a + 1) * len(edges)] = edges
        grid.append(flat.reshape(out_shape))
    return grid


def _brute_force(shape, grid, mode):
    D, H, W = shape
    seen = set()
    for x, y, z in zip(*(g.reshape(-1) for g in grid)):
        if mode == "nearest":
            seen.add(tuple(int(np.clip(np.round(c), 0, n - 1))
                           for c, n in zip((x, y, z), shape)))
            continue
        if not (x >= FLT_MIN and y >= FLT_MIN and z >= FLT_MIN
                and x <= D - 1 and y <= H - 1 and z <= W - 1):
            continue
        f = [int(np.floor(c)) for c in (x, y, z)]
        for a in {f[0], min(f[0] + 1, D - 1)}:
            for b in {f[1], min(f[1] + 1, H - 1)}:
                for c in {f[2], min(f[2] + 1, W - 1)}:
                    seen.add((a, b, c))
    return len(seen)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("seed,out_shape", [(0, (6, 7, 8)), (1, (3, 4, 30))])
def test_touched_source_voxels_matches_set_count(mode, seed, out_shape):
    src_shape = (9, 10, 11)
    grid = _grid(seed, out_shape, src_shape)
    want = _brute_force(src_shape, grid, mode)
    got = chip_smoke.touched_source_voxels(
        src_shape, [torch.from_numpy(g) for g in grid], mode)
    assert got == want
    assert 0 < got < np.prod(src_shape)


def test_kernel_cases_cover_every_kernel(monkeypatch):
    """chip_smoke.kernel_cases (also timed by scripts/compare_kernels.py) at
    a small size on the CPU, where each wrapper takes its plain version:
    one case per path shape, every C function covered, each library call
    of the output's size, and the byte bound at least the output's bytes."""
    monkeypatch.setattr(chip_smoke, "BANK", (24, 24, 24))
    monkeypatch.setattr(chip_smoke, "SERVE_WIN", (14, 15, 16))
    monkeypatch.setattr(chip_smoke, "ATLAS_SHAPE", (16, 16, 16))
    cfg = chip_smoke.process_args(chip_smoke.flagship_cfg())
    scfg = chip_smoke.SynthStatic.from_cfg(cfg)
    scfg = chip_smoke.SynthStatic(**{**scfg.__dict__, "size": (12, 12, 12)})
    cases = chip_smoke.kernel_cases(scfg, torch.device("cpu"))
    assert [c.name for c in cases] == [
        "warp_linear_f32 C=12", "warp_linear_f32 C=1",
        "warp_linear_f32 C=16 wall", "warp_linear_f32 C=1 lesion",
        "warp_linear_f32 C=56 one-hot", "warp_linear_f32 C=3 svf",
        "warp_nearest_i32",
        "lut_gather_i32 K=10000", "lut_gather_i32 K=56",
        "lut_gather_f32 K=256 C=8", *chip_smoke.SERVING_CASES,
        *chip_smoke.EVALUATE_CASES, *chip_smoke.NUMERICS_CASES,
        *chip_smoke.BENCH_CASES, *chip_smoke.ENTRY_CASES,
        *chip_smoke.GN_CASES, *chip_smoke.SEG_CASES]
    assert {c.fn for c in cases} == set(chip_smoke.SOURCES)
    # the atlas grid reaches past the atlas at its corners
    ii = chip_smoke.atlas_grid(torch.device("cpu"))[0]
    assert ii.min() < 0 or ii.max() > 15
    for c in cases:
        got, want = c.kernel(), c.plain()
        assert torch.equal(got, want), c.name
        lib = c.library()
        if c.fn == "chan_sums":
            # K3's yardstick is the library GroupNorm over its input
            assert lib.numel() == got.numel() // 2 * math.prod(
                c.info["shape"][2:]), c.name
        else:
            assert lib.numel() == got.numel(), c.name
        assert c.nbytes >= got.numel() * got.element_size(), c.name


@pytest.mark.parametrize("name", [*chip_smoke.VARIANTS, "twostage"])
def test_variant_configs_and_memory_settings(name):
    """Each of chip_smoke's variant configs is the shipped one at full
    width (f_maps 64, 160^3; L6 for joint_age, L5 for the rest), and its
    pinned memory setting is a remat mode whose accumulation divides the
    sample stack."""
    from brainfm_tpu_torch.models import process_args
    from brainfm_tpu_torch.models.unet3d import remat_mode

    cfg = process_args(chip_smoke.variant_cfg(name))
    remat, accum = (chip_smoke.TWOSTAGE_FIT if name == "twostage"
                    else chip_smoke.VARIANT_FIT[name])
    assert remat_mode(remat) == "save_convs"
    assert cfg.generator.all_samples % accum == 0
    assert int(cfg.f_maps) == 64 and list(cfg.generator.size) == [160] * 3
    assert int(cfg.num_levels) == (6 if name in ("joint_age", "critic")
                                   else 5)
    want = {"joint_age": ("age", -1), "sep": ("pathology", 1),
            "critic": ("T1", 1), "twostage": ("pathology", 1)}[name]
    assert cfg.out_channels[want[0]] == want[1]
    assert bool(cfg.losses.implicit_pathol) == (name == "critic")
    assert (cfg.backbone or "unet3d") == {"sep": "unet3d_sep",
                                          "twostage": "unet3d+unet3d"}.get(
        name, "unet3d")


def test_orbax_fixtures_load_strictly_on_the_cpu():
    """chip_smoke's orbax phase reading its fixtures on the CPU: each
    committed checkpoint (tests/fixtures/torch_orbax) exists, parses and
    loads strictly into its inferencer's model; the small model and the
    pair serve the fixture's input within the phase's bounds of the JAX
    outputs, and the flagship's every weight is the saved zero."""
    infs = chip_smoke.orbax_inferencers("cpu", flagship_dtype=torch.float32)
    assert set(infs) == {"small", "twostage", "flagship"}
    x = np.random.default_rng(0).random(chip_smoke.ORBAX_SIZE).astype(
        np.float32)
    for name in ("small", "twostage"):
        out = infs[name][0].evaluate_image(x, keep_feat=False)
        rel, agree, missing = chip_smoke._orbax_compare(out, name)
        assert not missing and rel, name
        assert max(rel.values()) <= chip_smoke.MODEL_TOL, (name, rel)
        assert agree >= chip_smoke.ORBAX_LABEL_AGREE, (name, agree)
    flagship = infs["flagship"][0].model
    assert sum(p.numel() for p in flagship.parameters()) == 264_067_558
    assert all(not p.any() for p in flagship.parameters())
