"""The CUDA kernels of brainfm_tpu_torch/csrc against their plain PyTorch
versions, on the GPU. They skip on a host without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from brainfm_tpu_torch.ops import interp, lut, warp

pytestmark = pytest.mark.cuda

# same fp32 operation order, no multiply-add contraction: expect 0
LINEAR_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid(rng, out_shape, src_shape, dev):
    """Coordinates over and beyond the source, with exact bounds, one ulp
    in and out, and .5 ties at the head of each axis."""
    grid = []
    for a, n in enumerate(src_shape):
        c = rng.uniform(-1.5, n + 0.5, out_shape).astype(np.float32)
        hi = np.float32(n - 1)
        edges = np.array([0.0, hi, np.nextafter(np.float32(0), np.float32(1)),
                          np.nextafter(hi, np.float32(n)),
                          np.nextafter(hi, np.float32(0)), -1e-7, 0.5,
                          hi - 0.5, 2.5, -2.0], np.float32)
        flat = c.reshape(-1)
        flat[a * 10:(a + 1) * 10] = edges
        grid.append(torch.from_numpy(flat.reshape(out_shape)).to(dev))
    return grid


@pytest.mark.parametrize("channels", [None, 1, 12])
def test_warp_linear_matches_plain(dev, channels):
    rng = np.random.default_rng(0)
    src_shape = (40, 41, 42)
    shape = src_shape + (() if channels is None else (channels,))
    vol = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    C = channels or 1
    dflt = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(dev)
    if channels is None:
        dflt = dflt[0]
    grid = _grid(rng, (30, 31, 29), src_shape, dev)
    got = warp.warp_volume(vol, grid, default=dflt)
    want = interp.trilinear3d(vol, *grid, dflt)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= LINEAR_ATOL


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
                                         ((4000, 5), torch.float32)])
def test_lut_gather_matches_plain_exactly(dev, shape, dtype):
    """Shared-memory tables and, beyond 48 KB ((20000,) i32, (4000, 5)
    f32), the __ldg path; indices -1 and >= K give 0."""
    g = torch.Generator(dev).manual_seed(2)
    table = (torch.randint(-100, 10000, shape, generator=g, device=dev)
             .to(dtype) if dtype == torch.int32
             else torch.randn(shape, generator=g, device=dev))
    K = shape[0]
    idx = torch.randint(-2, K + 2, (33, 35, 7), generator=g, device=dev,
                        dtype=torch.int32)
    got = lut.lut_apply(table, idx)
    assert got.dtype == dtype
    assert torch.equal(got, lut.lut_apply_plain(table, idx))


def test_wrappers_reject_bad_inputs(dev):
    vol = torch.zeros(8, 8, 8, device=dev)
    grid = [torch.zeros(4, 4, 4, device=dev) for _ in range(3)]
    with pytest.raises(TypeError):
        warp.warp_volume(vol.double(), grid)
    with pytest.raises(ValueError):
        warp.warp_volume(vol, [grid[0].cpu(), grid[1], grid[2]])
    with pytest.raises(TypeError):
        lut.lut_apply(torch.zeros(5, device=dev, dtype=torch.int64),
                      torch.zeros(3, device=dev, dtype=torch.int32))
