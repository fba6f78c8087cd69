"""The CUDA kernels of brainfm_tpu_torch/csrc against their plain PyTorch
versions, on the GPU. They skip on a host without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from brainfm_tpu_torch.ops import interp, lut, warp

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# same fp32 operation order, no multiply-add contraction: expect 0
LINEAR_ATOL = 1e-5
FLT_MIN = np.finfo(np.float32).tiny


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid(rng, out_shape, src_shape, dev):
    """Coordinates over and beyond the source, with exact bounds, one ulp
    in and out (the smallest denormal, FLT_MIN and the largest denormal
    among them), and .5 ties at the head of each axis."""
    grid = []
    for a, n in enumerate(src_shape):
        c = rng.uniform(-1.5, n + 0.5, out_shape).astype(np.float32)
        hi = np.float32(n - 1)
        edges = np.array([0.0, hi, np.nextafter(np.float32(0), np.float32(1)),
                          FLT_MIN, np.nextafter(FLT_MIN, np.float32(0)),
                          np.nextafter(hi, np.float32(n)),
                          np.nextafter(hi, np.float32(0)), -1e-7, 0.5,
                          hi - 0.5, 2.5, -2.0], np.float32)
        flat = c.reshape(-1)
        flat[a * len(edges):(a + 1) * len(edges)] = edges
        grid.append(torch.from_numpy(flat.reshape(out_shape)).to(dev))
    return grid


def _offset_view(t, offset=1):
    """A contiguous copy of `t` whose data_ptr sits `offset` elements past
    a 16-B boundary."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _linear_case(rng, channels, out_shape, dev, src_shape=(40, 41, 42)):
    shape = src_shape + (() if channels is None else (channels,))
    vol = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    C = channels or 1
    dflt = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(dev)
    if channels is None:
        dflt = dflt[0]
    return vol, _grid(rng, out_shape, src_shape, dev), dflt


def _assert_linear(vol, grid, dflt):
    got = warp.warp_volume(vol, grid, default=dflt)
    want = interp.trilinear3d(vol, *grid, dflt)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= LINEAR_ATOL


@pytest.mark.parametrize("channels", [None, 1, 3, 4, 8, 12])
def test_warp_linear_matches_plain(dev, channels):
    """Float4 channel quads (C % 4 == 0) and single channels (C = none, 1,
    3) on the brick grid."""
    rng = np.random.default_rng(0)
    _assert_linear(*_linear_case(rng, channels, (30, 31, 29), dev))


@pytest.mark.parametrize("channels", [1, 12])
@pytest.mark.parametrize("out_shape", [(7, 9, 11), (1001,), (140000, 1, 1),
                                       (2, 5, 6, 8)])
def test_warp_linear_ragged_and_flat(dev, channels, out_shape):
    """n and W not multiples of 4 or of the brick, a 1-D grid and a grid
    whose brick launch would not fit (the flat view), and leading
    dimensions folded into D."""
    rng = np.random.default_rng(3)
    _assert_linear(*_linear_case(rng, channels, out_shape, dev))


@pytest.mark.parametrize("channels", [1, 12])
@pytest.mark.parametrize("which", ["source", "coords"])
def test_warp_linear_misaligned_views(dev, channels, which):
    """A source or coordinate view whose data_ptr is not 16-B aligned (the
    source then takes single-channel loads) still matches."""
    rng = np.random.default_rng(4)
    vol, grid, dflt = _linear_case(rng, channels, (12, 13, 16), dev)
    if which == "source":
        vol = _offset_view(vol)
        assert vol.data_ptr() % 16 != 0
    else:
        grid = [_offset_view(c) for c in grid]
    _assert_linear(vol, grid, dflt)


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_nearest_matches_plain_exactly(dev, channels):
    rng = np.random.default_rng(1)
    src_shape = (40, 41, 42)
    shape = src_shape + (() if channels is None else (channels,))
    labels = torch.from_numpy(rng.integers(0, 56, shape).astype(np.int32)).to(dev)
    grid = _grid(rng, (30, 31, 29), src_shape, dev)
    assert torch.equal(warp.warp_labels(labels, grid),
                       interp.nearest3d(labels, *grid))


@pytest.mark.parametrize("shape,dtype", [((10000,), torch.int32),
                                         ((56,), torch.int32),
                                         ((256, 8), torch.float32),
                                         ((20000,), torch.int32),
                                         ((4000, 5), torch.float32),
                                         ((300, 12), torch.float32),
                                         ((60000,), torch.int32)])
@pytest.mark.parametrize("idx_shape", [(33, 35, 7), (5,)])
def test_lut_gather_matches_plain_exactly(dev, shape, dtype, idx_shape):
    """Tables in shared memory as they are (up to 48 KB), after the opt-in
    ((20000,) i32, (4000, 5) f32: 80 KB) and beyond 227 KB through __ldg
    ((60000,) i32: 240 KB); the row path (C % 4 == 0), the word path
    (C = 1) and the scalar path (C = 5); n % 4 != 0 (8085 and 5 indices);
    indices -1 and >= K give 0."""
    g = torch.Generator(dev).manual_seed(2)
    table = (torch.randint(-100, 10000, shape, generator=g, device=dev)
             .to(dtype) if dtype == torch.int32
             else torch.randn(shape, generator=g, device=dev))
    K = shape[0]
    idx = torch.randint(-2, K + 2, idx_shape, generator=g, device=dev,
                        dtype=torch.int32)
    got = lut.lut_apply(table, idx)
    assert got.dtype == dtype
    assert torch.equal(got, lut.lut_apply_plain(table, idx))


@pytest.mark.parametrize("shape,dtype", [((10000,), torch.int32),
                                         ((256, 8), torch.float32)])
def test_lut_gather_misaligned_views(dev, shape, dtype):
    """An index or table view whose data_ptr is not 16-B aligned takes the
    scalar path and still matches exactly."""
    g = torch.Generator(dev).manual_seed(5)
    table = torch.randn(shape, generator=g, device=dev).mul(100).to(dtype)
    K = shape[0]
    idx = torch.randint(-2, K + 2, (1001,), generator=g, device=dev,
                        dtype=torch.int32)
    for t, i in ((table, _offset_view(idx)), (_offset_view(table), idx)):
        assert torch.equal(lut.lut_apply(t, i), lut.lut_apply_plain(t, i))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_warp_linear_atlas_shape(dev):
    """Serving's deformed atlas: a 256^3 source on a 220^3 affine grid
    whose corners leave the atlas, edge coordinates at the head."""
    cs = _chip_smoke()
    g = torch.Generator(dev).manual_seed(6)
    atlas = torch.rand(cs.ATLAS_SHAPE, generator=g, device=dev)
    grid = cs.with_edges(cs.atlas_grid(dev), cs.ATLAS_SHAPE[0])
    ok = cs.in_bounds(*grid, cs.ATLAS_SHAPE)
    assert 0.5 < float(ok.float().mean()) < 1.0
    _assert_linear(atlas, grid, 0.0)


def test_lut_labels_on_cast_argmax(dev):
    """Serving's label map: the (56,) int32 label table over an argmax
    (int64) cast to int32."""
    from brainfm_tpu_torch.synth import LABELS_EXTRACEREBRAL

    g = torch.Generator(dev).manual_seed(7)
    logits = torch.randn((1, 60, 61, 62, 56), generator=g, device=dev)
    idx = logits.argmax(-1)
    assert idx.dtype == torch.int64
    table = torch.tensor(LABELS_EXTRACEREBRAL, dtype=torch.int32, device=dev)
    got = lut.lut_apply(table, idx.to(torch.int32))
    assert got.dtype == torch.int32
    assert torch.equal(got, table[idx])


def test_small_inferencer_gpu_matches_cpu(dev, tmp_path):
    """A small model served on the GPU (fp32, TF32 off) and on the CPU from
    one state dict: every output, the labels (K2) and the deformed atlas
    (K1), the atlas on the same inputs."""
    from brainfm_tpu_torch.infer import (Inferencer, get_deformed_atlas,
                                         prepare_image)
    from brainfm_tpu_torch.utils.nifti import save_nifti

    cs = _chip_smoke()
    shape, vox = (30, 36, 24), cs.SERVE_VOXEL_MM
    img = str(tmp_path / "h.nii")
    save_nifti(img, cs.procedural_head(shape, vox, 3, "cpu"),
               cs.serve_affine(shape, vox))
    atlas = str(tmp_path / "a.mgz")
    cs.write_mgz(atlas, cs.procedural_atlas((48, 48, 48), 4, "cpu"),
                 (4.0, 4.0, 4.0))
    gpu = Inferencer(cs.small_model_cfg(), device=dev)
    cpu = Inferencer(cs.small_model_cfg(), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    kw = dict(win_size=[32, 32, 32], spacing=(1.0, 2.0, 1.0))
    ig = prepare_image(img, device=dev, **kw)[0]
    ic = prepare_image(img, device="cpu", **kw)[0]
    assert float((ig.cpu() - ic).abs().max()) <= cs.REPLAY_TOL
    og = gpu.evaluate_image(ig, keep_feat=False)
    oc = cpu.evaluate_image(ic, keep_feat=False)
    assert set(og) == set(oc)
    for k in og:
        if k == "label":
            agree = float((og[k].cpu() == oc[k]).float().mean())
            assert agree >= cs.SEG_AGREE, agree
        else:
            assert cs._rel_err(og[k], oc[k]) <= cs.MODEL_TOL, k
    args = [oc[k][0, ..., 0] for k in ("label", "regx", "regy", "regz")]
    ag = get_deformed_atlas(*[a.to(dev) for a in args], atlas_path=atlas)
    ac = get_deformed_atlas(*args, atlas_path=atlas)
    assert float((ag.cpu() - ac).abs().max()) <= LINEAR_ATOL


def test_wrappers_reject_bad_inputs(dev):
    vol = torch.zeros(8, 8, 8, device=dev)
    grid = [torch.zeros(4, 4, 4, device=dev) for _ in range(3)]
    with pytest.raises(TypeError):
        warp.warp_volume(vol.double(), grid)
    with pytest.raises(ValueError):
        warp.warp_volume(vol, [grid[0].cpu(), grid[1], grid[2]])
    with pytest.raises(ValueError, match="channels"):
        warp.warp_volume(torch.zeros(2, 2, 2, warp.MAX_CHANNELS + 1,
                                     device=dev), grid)
    with pytest.raises(TypeError):
        lut.lut_apply(torch.zeros(5, device=dev, dtype=torch.int64),
                      torch.zeros(3, device=dev, dtype=torch.int32))
