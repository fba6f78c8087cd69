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

from brainfm_tpu_torch import kernels
from brainfm_tpu_torch.ops import groupnorm, interp, lut, warp

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


@pytest.mark.parametrize("channels", [None, 1, 3, 4, 8, 12, 16, 56])
def test_warp_linear_matches_plain(dev, channels):
    """Float4 channel quads (C % 4 == 0) and single channels (C = none, 1,
    3) on the brick grid; 16 is the pathology item's target wall, 56 the
    one-hot segmentation (deform_one_hots)."""
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


def test_integrate_svf_through_k1_matches_plain(dev):
    """Scaling and squaring (synth/deform.py::integrate_svf) composes the
    field through K1 on the card: at its coordinates (the identity grid
    plus the field, some of them outside the volume) K1 gives
    trilinear3d's values, so the integrated field and its inverse match
    the CPU's."""
    from brainfm_tpu_torch.synth.deform import integrate_svf

    rng = np.random.default_rng(5)
    F = torch.from_numpy(3 * rng.standard_normal((20, 22, 18, 3))
                         .astype(np.float32))
    gf, gn = integrate_svf(F.to(dev), 8)
    cf, cn = integrate_svf(F, 8)
    assert float((gf.cpu() - cf).abs().max()) <= LINEAR_ATOL
    assert float((gn.cpu() - cn).abs().max()) <= LINEAR_ATOL
    f = (F / 16).to(dev)
    xx, yy, zz = torch.meshgrid(*[torch.arange(n, dtype=torch.float32,
                                               device=dev)
                                  for n in f.shape[:3]], indexing="ij")
    grid = [(xx + f[..., 0]).contiguous(), (yy + f[..., 1]).contiguous(),
            (zz + f[..., 2]).contiguous()]
    _assert_linear(f.contiguous(), grid, 0.0)


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


# K3-K5 (csrc/groupnorm.cu). K3 sums in another order than its plain
# version: within these multiples of sum|u * v| (fp32 accumulators for
# bf16 and fp32 inputs, fp64 for fp64); K4 and K5 round like their plain
# versions, operation for operation: expect equality.
SUMS_RTOL = {torch.bfloat16: 1e-5, torch.float32: 1e-5, torch.float64: 1e-13}
GN_DTYPES = [torch.bfloat16, torch.float32, torch.float64]
# (N, C, spatial), channels-last: 16-B voxels, odd widths (one element a
# thread), many voxel chunks, one channel, the 2-D UNet's NHWC, two, 192
# (24 vectors, not dividing the block) and 3072 channels (passes of 256)
GN_SHAPES = [(2, 16, (8, 8, 8)), (1, 5, (7, 9, 11)), (4, 3, (96, 80, 72)),
             (1, 1, (33, 32, 31)), (2, 24, (20, 24)), (1, 2, (30, 31, 29)),
             (2, 192, (9, 10, 11)), (1, 3072, (3, 4, 5))]


def _gn_input(shape, dtype, dev, seed, shift=0.5, last=True):
    """Seeded values of `shape`, channels-last unless `last` is False."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = (torch.randn(shape, generator=g, dtype=torch.float64)
         + shift).to(dtype).to(dev)
    return _last(t) if last and t.dim() > 2 else t


def _last(t):
    """t's values with channels innermost (N, ..., C) in memory."""
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def _assert_sums(got, u, v):
    want = groupnorm.chan_sums_plain(u, v)
    vv = u if v is None else v
    dims = tuple(range(2, u.dim()))
    mag = torch.stack([u.double().abs().sum(dims),
                       (u.double() * vv.double()).abs().sum(dims)])
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.double() - want.double()).abs()
    assert bool((err <= SUMS_RTOL[u.dtype] * (mag.to(err.device) + 1))
                .all()), float(err.max())


@pytest.mark.parametrize("dtype", GN_DTYPES)
@pytest.mark.parametrize("N,C,spatial", GN_SHAPES)
def test_chan_sums_matches_plain(dev, N, C, spatial, dtype):
    u = _gn_input((N, C, *spatial), dtype, dev, 1)
    v = _gn_input((N, C, *spatial), dtype, dev, 2, shift=-0.2)
    for vv in (None, v):
        before = kernels.LAUNCHES["chan_sums"]
        got = groupnorm.chan_sums(u, vv)
        assert kernels.LAUNCHES["chan_sums"] == before + 1
        _assert_sums(got, u, vv)
        # two-stage and atomic-free: bitwise the same on a second run
        assert torch.equal(got, groupnorm.chan_sums(u, vv))


@pytest.mark.parametrize("dtype", GN_DTYPES)
@pytest.mark.parametrize("N,C,spatial", GN_SHAPES)
def test_chan_affines_match_plain_exactly(dev, N, C, spatial, dtype):
    x = _gn_input((N, C, *spatial), dtype, dev, 3)
    dy = _gn_input((N, C, *spatial), dtype, dev, 4, shift=0.0)
    sdt = groupnorm.stats_dtype(dtype)
    a = _gn_input((N, C), sdt, dev, 5)
    b = _gn_input((N, C), sdt, dev, 6)
    y = groupnorm.chan_affine(x, a, b)
    # the output keeps x's strides
    assert y.dtype == dtype and y.stride() == x.stride()
    assert torch.equal(y, groupnorm.chan_affine_plain(x, a, b))
    P, Q, R = (_gn_input((N, C), dtype, dev, 7 + i) * 0.1 for i in range(3))
    dx = groupnorm.chan_affine3(dy, x, P, Q, R)
    assert dx.stride() == x.stride()
    assert torch.equal(dx, groupnorm.chan_affine3_plain(dy, x, P, Q, R))


def _offset_last(t, offset=1):
    """A channels-last copy of `t` whose data_ptr sits `offset` elements
    past a 16-B boundary."""
    return _offset_view(t.movedim(1, -1).contiguous()).movedim(-1, 1)


@pytest.mark.parametrize("fn", ["sums", "affine", "affine3"])
def test_chan_kernels_on_misaligned_views(dev, fn):
    """Voxels of 8 bf16 channels (16 B) starting one element past a 16-B
    boundary take the one-element path."""
    shape, C = (2, 8, 4, 4, 4), 8
    x = _offset_last(_gn_input(shape, torch.bfloat16, dev, 8))
    dy = _offset_last(_gn_input(shape, torch.bfloat16, dev, 9))
    assert x.movedim(1, -1).is_contiguous() and x.data_ptr() % 16
    if fn == "sums":
        _assert_sums(groupnorm.chan_sums(dy, x), dy, x)
    elif fn == "affine":
        a, b = (_gn_input((2, C), torch.float32, dev, s) for s in (1, 2))
        assert torch.equal(groupnorm.chan_affine(x, a, b),
                           groupnorm.chan_affine_plain(x, a, b))
    else:
        P, Q, R = (_gn_input((2, C), torch.bfloat16, dev, s)
                   for s in (1, 2, 3))
        assert torch.equal(groupnorm.chan_affine3(dy, x, P, Q, R),
                           groupnorm.chan_affine3_plain(dy, x, P, Q, R))


def test_chan_kernels_refuse_other_strides(dev):
    """Channels-last operands are taken; a sliced view, half precision,
    coefficients of another dtype and operands on two devices are
    refused."""
    cl = _gn_input((2, 8, 4, 4, 4), torch.float32, dev, 1)
    a = torch.ones(2, 8, device=dev)
    _assert_sums(groupnorm.chan_sums(cl), cl, None)
    assert torch.equal(groupnorm.chan_affine(cl, a, a),
                       groupnorm.chan_affine_plain(cl, a, a))
    x = cl.contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.chan_affine(x[:, :, ::2], a, a)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.chan_sums(cl[:, :, 1:])
    with pytest.raises(TypeError):
        groupnorm.chan_sums(cl.half())
    with pytest.raises(ValueError):
        groupnorm.chan_affine(x, a.double(), a.double())
    with pytest.raises(ValueError):
        groupnorm.chan_affine(cl, a.double(), a.double())
    with pytest.raises(ValueError):
        groupnorm.chan_sums(cl, cl.cpu())


# (kernel, which operands arrive contiguous (N, C, ...), i.e. NCDHW, and
# not channels-last), the activation x last
GN_NCDHW = ([("sums", nc) for nc in ((1,), (1, 0), (0, 1), (1, 1))]
            + [("affine", (1,))]
            + [("affine3", nc) for nc in ((1, 0), (0, 1), (1, 1))])


@pytest.mark.parametrize("fn,nc", GN_NCDHW)
def test_chan_kernels_copy_mixed_operands_once(dev, fn, nc):
    """NCDHW operands, as from a caller outside the network: each is
    copied once into channels-last (one `layout.copies` an operand), the
    result is the plain version's and the output channels-last."""
    from brainfm_tpu_torch.utils import profiling

    ops = [_gn_input((2, 16, 6, 5, 4), torch.bfloat16, dev, s, last=not c)
           for s, c in enumerate(nc, 1)]
    sdt = torch.float32 if fn == "affine" else torch.bfloat16
    cs = [_gn_input((2, 16), sdt, dev, s)
          for s in range({"sums": 0, "affine": 2, "affine3": 3}[fn])]
    with profiling.recording():
        got = getattr(groupnorm, f"chan_{fn}")(*ops, *cs)
    assert profiling.COUNTS.get("layout.copies", 0) == sum(nc)
    if fn == "sums":
        _assert_sums(got, *ops, *[None] * (2 - len(ops)))
    else:
        assert got.movedim(1, -1).is_contiguous() and not got.is_contiguous()
        assert torch.equal(got, getattr(groupnorm, f"chan_{fn}_plain")(
            *ops, *cs))


def _rel(a, b):
    return float((a.double().cpu() - b.double().cpu()).norm()
                 / b.double().cpu().norm().clamp(min=1e-300))


@pytest.mark.parametrize("pair", [False, True])
def test_group_norms_on_the_card_match_the_cpu_fp64(dev, pair):
    """The autograd Functions end to end at fp64: values 1e-12 and
    gradients 1e-10 relative (K3 sums in another order)."""
    rng = np.random.default_rng(12)
    C = 24
    shapes = [(2, 8, 12, 10, 8), (2, 16, 6, 5, 4)] if pair \
        else [(2, C, 11, 9, 7)]
    ins = [torch.from_numpy(rng.standard_normal(s) + 0.3) for s in shapes]
    gs = [torch.from_numpy(rng.standard_normal(s)) for s in shapes]
    sc = torch.from_numpy(rng.standard_normal(C))
    bi = torch.from_numpy(rng.standard_normal(C))
    fn = groupnorm.pair_group_norm if pair else groupnorm.fused_group_norm
    res = []
    for d in ("cpu", dev):
        args = [t.to(d).requires_grad_(True) for t in (*ins, sc, bi)]
        out = fn(*args, 8)
        out = out if pair else (out,)
        grads = torch.autograd.grad(out, args, [g.to(d) for g in gs])
        res.append(([o.detach() for o in out], grads))
    for a, b in zip(res[1][0], res[0][0]):
        assert _rel(a, b) <= 1e-12
    for a, b in zip(res[1][1], res[0][1]):
        assert _rel(a, b) <= 1e-10


def test_bf16_group_norm_on_the_card_matches_the_cpu(dev):
    """bf16 under fp32 coefficients that differ from the CPU's in their
    last bits (K3's summation order): values within one bf16 ulp, or 1e-5
    where the fp32 value near 0 rounds to neighbours finer than that;
    dtypes kept."""
    x = _gn_input((4, 64, 20, 20, 20), torch.bfloat16, "cpu", 13)
    sc = torch.linspace(0.5, 1.5, 64)
    bi = torch.linspace(-0.2, 0.2, 64)
    want = groupnorm.fused_group_norm(x, sc, bi, 8)
    got = groupnorm.fused_group_norm(x.to(dev), sc.to(dev), bi.to(dev), 8)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * torch.maximum(got.float().cpu().abs(),
                                    want.float().abs())
    err = (got.float().cpu() - want.float()).abs()
    assert bool((err <= ulp + 1e-5).all()), float((err - ulp).max())


def test_phase_pair_conv_and_unet_on_the_card_match_the_cpu(dev):
    """A small UNet3D whose every decoder level takes the pair, fp64 loss
    and gradients on the card (K3-K5, the pair conv) against the CPU."""
    from brainfm_tpu_torch.models.unet3d import UNet3D

    torch.manual_seed(0)
    cpu = UNet3D(f_maps=8, num_levels=3).double()
    gpu = UNet3D(f_maps=8, num_levels=3).double().to(dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 1, 24, 24, 24, dtype=torch.float64)
    w = torch.randn(2, 8, 24, 24, 24, dtype=torch.float64)
    kernels.reset_launches()
    lg = (gpu(x.to(dev)) * w.to(dev)).sum()
    lg.backward()
    lc = (cpu(x) * w).sum()
    lc.backward()
    assert abs(float(lg) - float(lc)) <= 1e-10 * abs(float(lc))
    for (k, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        assert _rel(a.grad, b.grad) <= 1e-9, k
    for fn in ("chan_sums", "chan_affine", "chan_affine3"):
        assert kernels.LAUNCHES[fn] > 0, fn


# The 3-D network in NDHWC on the card (models/build.py::_model_input)
# against the same network given an NCDHW input there (the first
# convolution runs NCDHW, and each GroupNorm kernel copies an NCDHW
# operand into channels-last), a flagship-config step at a
# small crop, in fp32 (TF32 off) and under bf16 autocast. The losses agree
# within BF16_LOSS_REL and the fp32 gradients within BF16_GRAD_REL (global
# relative L2), the bf16 limits of tests/test_torch_groupnorm.py
# (tests/test_phase_upconv.py's TOLERANCE NOTE). This step's gradients are
# ill-conditioned at a 32^3 crop (GroupNorm over a few deep voxels, unit
# features): the CPU's own fp32 gradients lie about 1.4e-2 from its fp64
# ones, and the bf16 step's about 0.8 from the fp32 step's. So the bf16
# gradients are held to that: the layout moves them less than bf16 moves
# them from fp32.
BF16_LOSS_REL = 1e-3
BF16_GRAD_REL = 2e-2
FLAGSHIP_CROP = (32, 32, 32)


def _flagship_small(dev, crop=FLAGSHIP_CROP[0]):
    from brainfm_tpu_torch.models.build import build_model
    from brainfm_tpu_torch.models.criterion import make_criterion

    cs = _chip_smoke()
    cfg = cs.flagship_cfg()
    cfg.generator.size = [crop] * 3
    torch.manual_seed(0)
    cfg, model = build_model(cfg, device=dev)
    _, weight_dict, loss_fn = make_criterion(cfg)
    batch = cs._to_dev(cs.ref_train_batch(cfg, B=1, S=2), dev)
    return cfg, model, weight_dict, loss_fn, batch


def _step_loss_grads(cfg, model, weight_dict, loss_fn, batch, amp=True):
    from brainfm_tpu_torch.models.criterion import weighted_total
    from brainfm_tpu_torch.train.step import batch_losses

    model.zero_grad(set_to_none=True)
    losses = batch_losses(model, cfg, loss_fn, batch, amp=amp)
    total = weighted_total(losses, weight_dict)
    total.backward()
    grads = torch.cat([p.grad.detach().double().reshape(-1)
                       for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def test_flagship_step_channels_last_matches_ncdhw(dev, monkeypatch):
    from brainfm_tpu_torch.models import build

    args = _flagship_small(dev)
    res = {}
    for layout in ("ndhwc", "ncdhw"):
        if layout == "ncdhw":
            monkeypatch.setattr(build, "_model_input", lambda x: x.movedim(
                -1, 1).clone(memory_format=torch.contiguous_format))
        for amp in (False, True):
            res[layout, amp] = _step_loss_grads(*args, amp=amp)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for amp in (False, True):
        (cl_loss, _), (nc_loss, _) = res["ndhwc", amp], res["ncdhw", amp]
        assert abs(cl_loss - nc_loss) <= BF16_LOSS_REL * abs(nc_loss), amp
    fp32 = rel(res["ndhwc", False][1], res["ncdhw", False][1])
    assert fp32 <= BF16_GRAD_REL, fp32
    bf16 = rel(res["ndhwc", True][1], res["ncdhw", True][1])
    rounding = rel(res["ncdhw", True][1], res["ncdhw", False][1])
    assert bf16 <= rounding, (bf16, rounding)


def _layout_kernels(fn, dev):
    """The ops that launch a layout conversion kernel (cuDNN's nchwToNhwc
    or nhwcToNchw) in fn(), with their input shapes, and the port's
    `layout.copies`."""
    from torch.profiler import ProfilerActivity, profile

    from brainfm_tpu_torch.utils import profiling

    fn()   # cuDNN's algorithm search outside the profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, profiling.recording():
        fn()
        torch.cuda.synchronize(dev)
    ops = [(e.name, e.input_shapes) for e in prof.events()
           if any("nchwToNhwc" in k.name or "nhwcToNchw" in k.name
                  for k in e.kernels)]
    return ops, profiling.COUNTS.get("layout.copies", 0)


def _one_channel_conv(op):
    """The network's first convolution, on its one input channel, which
    cuDNN widens to its vector width in a layout kernel of its own
    whatever the layout (the NCDHW network launched the same)."""
    name, shapes = op
    x = shapes[0] if name == "aten::cudnn_convolution" else shapes[1]
    return "convolution" in name and len(x) == 5 and x[1] == 1


def test_unet_on_the_card_converts_no_layout(dev):
    """A flagship-config training step at 64^3 (bf16, save_convs: the
    forward, its recomputation and the backward) and a served forward at
    68^3, whose deepest decoder levels upsample and concatenate: no layout
    conversion kernel but the first convolution's, and the port copies
    nothing to change a layout."""
    cfg, model, weight_dict, loss_fn, batch = _flagship_small(dev, 64)
    ops, copies = _layout_kernels(
        lambda: _step_loss_grads(cfg, model, weight_dict, loss_fn, batch),
        dev)
    assert copies == 0
    assert all(_one_channel_conv(op) for op in ops), ops
    x = torch.rand((1, 68, 68, 68, 1), device=dev)

    def serve():
        with torch.inference_mode(), torch.autocast("cuda",
                                                    dtype=torch.bfloat16):
            model(x)

    ops, copies = _layout_kernels(serve, dev)
    assert copies == 0
    assert all(_one_channel_conv(op) for op in ops), ops


# ---- the segmentation losses (csrc/segloss.cu) against their plain
# version on the card: the eager chain (ops/segloss.py seg_losses_plain),
# within the yardstick that module states (`loss_excess`, `grad_excess`).
SEG_SHAPE = (12, 10, 14)


def _seg_inputs(dev, dtype, S, width, shape=SEG_SHAPE, L=56, soft=False,
                seed=0):
    """(leaf, logits, target, w): the logits a view at channel offset 5 of
    a `width`-wide NDHWC head tensor (the leaf), or dense for width None;
    a one-hot (or soft) fp32 target with one label absent from it and from
    the logits; lesion-weighted labels."""
    g = torch.Generator(dev).manual_seed(seed)
    if width is None:
        leaf = torch.randn((S, *shape, L), generator=g, device=dev)
    else:
        leaf = torch.randn((S, width, *shape), generator=g, device=dev)
    leaf = (leaf * 3).to(dtype)
    if width is not None:
        leaf = leaf.contiguous(memory_format=torch.channels_last_3d)
    logits = (leaf if width is None
              else leaf.narrow(1, 5, L).movedim(1, -1))
    logits[..., L - 1] = -60.0       # the absent label: its union clamps
    leaf.requires_grad_(True)
    logits = (leaf if width is None
              else leaf.narrow(1, 5, L).movedim(1, -1))
    lab = torch.randint(0, L - 1, shape, generator=g, device=dev)
    if soft:
        t = torch.rand((*shape, L), generator=g, device=dev) ** 4
        t[..., L - 1] = 0
        t = t / t.sum(-1, keepdim=True)
    else:
        t = torch.nn.functional.one_hot(lab, L).float()
    w = torch.ones(L, device=dev)
    w[7 % L] = 5.0
    return leaf, logits, t[None], w / w.sum()


def _seg_run(fn, leaf, logits, t, w, gl=(0.7, 1.3)):
    """(losses, dL/dlogits) of fn with upstream gradients gl."""
    losses = fn(logits, t, w)
    (dx,) = torch.autograd.grad(losses, logits, [torch.tensor(
        v, dtype=losses[0].dtype, device=leaf.device) for v in gl])
    return torch.stack(losses).detach(), dx


def _assert_seg_close(got, want, dtype):
    from brainfm_tpu_torch.ops import segloss

    (gl, gx), (wl, wx) = got, want
    assert gx.dtype == wx.dtype == dtype and gx.shape == wx.shape
    assert segloss.loss_excess(gl, wl) <= 0, (gl, wl)
    excess = segloss.grad_excess(gx, wx)
    assert excess <= 0, excess


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [72, 64, None])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_seg_loss_kernels_match_plain(dev, dtype, width, S):
    from brainfm_tpu_torch.ops import segloss

    args = _seg_inputs(dev, dtype, S, width, soft=S == 2)
    before = dict(kernels.LAUNCHES)
    got = _seg_run(segloss.seg_losses, *args)
    assert {k: kernels.LAUNCHES[k] - before[k] for k in
            ("seg_loss_fwd", "seg_loss_bwd")} == {"seg_loss_fwd": 1,
                                                  "seg_loss_bwd": 1}
    _assert_seg_close(got, _seg_run(segloss.seg_losses_plain, *args), dtype)


@pytest.mark.parametrize("case", ["fp64", "fp32 S=5", "L=64", "L=3"])
def test_seg_loss_kernels_other_widths(dev, case):
    """fp64 (the card's reference phases run fp64 steps), a fifth sample
    (a second block of samples), the most labels and a few."""
    from brainfm_tpu_torch.ops import segloss

    dtype = torch.float64 if case == "fp64" else torch.float32
    S = 5 if case == "fp32 S=5" else 2
    L = {"L=64": 64, "L=3": 3}.get(case, 56)
    args = _seg_inputs(dev, dtype, S, 72, L=L, soft=case == "fp64", seed=1)
    _assert_seg_close(_seg_run(segloss.seg_losses, *args),
                      _seg_run(segloss.seg_losses_plain, *args), dtype)


def test_seg_loss_kernels_at_the_flagship_shape(dev):
    """4 samples of 160^3 x 56 bf16 logits at channel offset 5 of the
    flagship's 72-wide head tensor."""
    from brainfm_tpu_torch.ops import segloss

    args = _seg_inputs(dev, torch.bfloat16, 4, 72, shape=(160,) * 3)
    got = _seg_run(segloss.seg_losses, *args)
    _assert_seg_close(got, _seg_run(segloss.seg_losses_plain, *args),
                      torch.bfloat16)


def test_seg_loss_kernels_repeat_bitwise(dev):
    from brainfm_tpu_torch.ops import segloss

    args = _seg_inputs(dev, torch.bfloat16, 4, 72, shape=(40, 48, 36))
    (l1, d1), (l2, d2) = (_seg_run(segloss.seg_losses, *args)
                          for _ in range(2))
    assert torch.equal(l1, l2) and torch.equal(d1, d2)


def test_seg_loss_copies_other_strides_once(dev):
    """NCDHW logits (labels not contiguous) are copied once, counted as
    `layout.copies`; the head view is taken where it lies."""
    from brainfm_tpu_torch.ops import segloss
    from brainfm_tpu_torch.utils import profiling

    leaf, logits, t, w = _seg_inputs(dev, torch.bfloat16, 2, 72)
    nc = logits.detach().movedim(-1, 1).contiguous().movedim(1, -1)
    for x, copies in ((logits, 0), (nc.requires_grad_(True), 1)):
        with profiling.recording():
            got = _seg_run(segloss.seg_losses, leaf, x, t, w)
        assert profiling.COUNTS.get("layout.copies", 0) == copies
        assert profiling.COUNTS["loss.seg_kernel"] == 1
        _assert_seg_close(got, _seg_run(segloss.seg_losses_plain, leaf, x,
                                        t, w), torch.bfloat16)


@pytest.mark.parametrize("bad", ["fp16", "labels", "target", "weights"])
def test_seg_loss_wrapper_refuses(dev, bad):
    from brainfm_tpu_torch.ops import segloss

    x = torch.zeros((2, 4, 5, 6, 56), device=dev)
    t = torch.zeros((1, 4, 5, 6, 56), device=dev)
    w = torch.ones(56, device=dev)
    if bad == "fp16":
        x = x.half()
    if bad == "labels":
        x, t, w = (torch.zeros(a.shape[:-1] + (65,), device=dev)
                   for a in (x, t, w))
    if bad == "target":
        t = torch.zeros((2, 4, 5, 6, 56), device=dev)
    if bad == "weights":
        w = w.cpu()
    before = dict(kernels.LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        segloss.seg_losses(x, t, w)
    assert kernels.LAUNCHES == before


def test_flagship_step_takes_the_seg_loss_kernels_once(dev):
    """A flagship-config bf16 training step: each pass launched once,
    `loss.seg_kernel` once, no layout copy, and no softmax kernel on the
    card."""
    from torch.profiler import ProfilerActivity, profile

    from brainfm_tpu_torch.utils import profiling

    args = _flagship_small(dev)
    _step_loss_grads(*args)   # cuDNN's choices outside the count
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            profiling.recording():
        _step_loss_grads(*args)
        torch.cuda.synchronize(dev)
    counts = dict(profiling.COUNTS)
    assert {k: kernels.LAUNCHES[k] - before[k] for k in
            ("seg_loss_fwd", "seg_loss_bwd")} == {"seg_loss_fwd": 1,
                                                  "seg_loss_bwd": 1}
    assert counts["loss.seg_kernel"] == 1
    assert counts.get("layout.copies", 0) == 0
    names = {k.name for e in prof.events() for k in e.kernels}
    assert any("segloss_bwd_kernel" in n for n in names), names
    assert not any("softmax" in n.lower() for n in names), names
