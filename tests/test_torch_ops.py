"""brainfm_tpu_torch/ops against brainfm_tpu/ops on the CPU.

On the CPU the port's kernel wrappers take their plain PyTorch versions
and the JAX routers take the XLA gather, the reference the Pallas kernels
are held to (tests/test_pallas_warp_blocks.py). Inputs are made with numpy
from a seed. The CUDA kernels against the plain versions are in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brainfm_tpu.ops import pallas_lut, warp_auto
from brainfm_tpu_torch import kernels
from brainfm_tpu_torch.ops import blur, interp, lut, separable, warp

# linear warps: both sides blend in fp32 in the same operation order; XLA
# may contract a multiply-add, so allow a few ulps of O(10) values
LINEAR_ATOL = 1e-5
FLT_MIN = np.finfo(np.float32).tiny


def _coords(rng, out_shape, src_shape):
    """Coordinates spread over and beyond the source, with exact bounds,
    just-inside/outside values (the smallest denormal, FLT_MIN and the
    largest denormal among them) and .5 ties at the head of each axis."""
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
        grid.append(flat.reshape(out_shape))
    return grid


@pytest.mark.parametrize("channels", [None, 1, 12])
def test_warp_volume_matches_jax(channels):
    rng = np.random.default_rng(0)
    src_shape = (12, 13, 14)
    shape = src_shape + (() if channels is None else (channels,))
    vol = rng.standard_normal(shape).astype(np.float32) * 10
    grid = _coords(rng, (9, 10, 11), src_shape)
    default = (np.float32(0.25) if channels is None
               else rng.standard_normal(channels).astype(np.float32))
    want = warp_auto.warp_volume(jnp.asarray(vol),
                                 tuple(map(jnp.asarray, grid)), None,
                                 default=jnp.asarray(default))
    got = warp.warp_volume(torch.from_numpy(vol),
                           tuple(map(torch.from_numpy, grid)),
                           default=torch.from_numpy(np.asarray(default)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LINEAR_ATOL)
    # the out-of-bounds voxels take the default exactly
    oob = ~((grid[0] >= FLT_MIN) & (grid[1] >= FLT_MIN) & (grid[2] >= FLT_MIN)
            & (grid[0] <= 11) & (grid[1] <= 12) & (grid[2] <= 13))
    assert oob.any()
    np.testing.assert_array_equal(
        got.numpy()[oob], np.broadcast_to(default, got.numpy()[oob].shape))


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_labels_matches_jax_exactly(channels):
    """Nearest: round half to even on the .5 ties, then clip; exact."""
    rng = np.random.default_rng(1)
    src_shape = (10, 11, 12)
    shape = src_shape + (() if channels is None else (channels,))
    vol = rng.integers(0, 56, shape).astype(np.int32)
    grid = _coords(rng, (8, 9, 7), src_shape)
    want = warp_auto.warp_labels(jnp.asarray(vol),
                                 tuple(map(jnp.asarray, grid)), None)
    got = warp.warp_labels(torch.from_numpy(vol),
                           tuple(map(torch.from_numpy, grid)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ties go to the even neighbour (2.5 -> 2), as jnp.round
    assert interp.nearest3d(torch.arange(6, dtype=torch.int32).reshape(
        6, 1, 1), *(torch.tensor([2.5, 3.5]), torch.zeros(2),
                    torch.zeros(2))).tolist() == [2, 4]


@pytest.mark.parametrize("K,C,dtype", [(10000, None, np.int32),
                                       (56, None, np.int32),
                                       (256, 8, np.float32),
                                       (7, 3, np.int32)])
def test_lut_apply_matches_jax_exactly(K, C, dtype):
    """Indices -1 and >= K give 0; an integer table keeps its dtype."""
    rng = np.random.default_rng(2)
    shape = (K,) if C is None else (K, C)
    table = (rng.integers(-50, 5000, shape) if dtype == np.int32
             else rng.standard_normal(shape) * 100).astype(dtype)
    idx = rng.integers(-3, K + 3, (6, 7, 5)).astype(np.int32)
    idx.reshape(-1)[:3] = [-1, K, K - 1]
    want = pallas_lut.lut_apply(jnp.asarray(table), jnp.asarray(idx))
    got = lut.lut_apply(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.reshape(-1, 1 if C is None else C)[:2] == 0).all()


def test_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor CUDA (here 'meta'), or
    tensors split across devices, raise instead of taking the plain path."""
    table = torch.zeros(5, dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        lut.lut_apply(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        lut.lut_apply(table, idx.to("meta"))
    vol = torch.zeros(4, 4, 4)
    grid = tuple(torch.zeros(2, 2, 2, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        warp.warp_volume(vol.to("meta"), grid)
    with pytest.raises(ValueError):
        warp.warp_labels(vol.int(), grid)


def test_kernel_build_is_keyed_by_source_and_flags():
    """Libraries are compiled for sm_90a into the git-ignored build dir,
    one per source, and named by a hash of source + flags."""
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert set(kernels.SOURCES) == {"warp", "lut"}
    for name in kernels.SOURCES:
        p = kernels.library_path(name)
        assert p.parent == kernels.BUILD_DIR
        assert p == kernels.library_path(name)
        assert (kernels.CSRC / f"{name}.cu").is_file()
    assert kernels.library_path("warp") != kernels.library_path("lut")


@pytest.mark.parametrize("n_out,n_in,mask", [(20, 9, False), (16, 16, True),
                                             (7, 30, True)])
def test_linear_resample_matrix_matches_jax(n_out, n_in, mask):
    from brainfm_tpu.ops import separable as jsep

    rng = np.random.default_rng(3)
    coords = rng.uniform(-1, n_in + 1, n_out).astype(np.float32)
    coords[:2] = [0.0, n_in - 1]
    upper = np.float32(n_in - 2.5)
    for up in (None, upper):
        want = jsep.linear_resample_matrix(jnp.asarray(coords), n_in,
                                           upper=up, mask_oob=mask)
        got = separable.linear_resample_matrix(
            torch.from_numpy(coords), n_in,
            upper=None if up is None else torch.tensor(up), mask_oob=mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n_in", [4, 9])
def test_linear_resample_matrix_mask_denormals_match_jax(n_in):
    """mask_oob's lower bound at the denormals: XLA flushes them to zero,
    so the reference's `coords > 0` masks them; the port's `>= FLT_MIN`
    must give the same rows (zero rows for the denormals)."""
    from brainfm_tpu.ops import separable as jsep

    hi = np.float32(n_in - 1)
    den_lo = np.nextafter(np.float32(0), np.float32(1))
    den_hi = np.nextafter(FLT_MIN, np.float32(0))
    coords = np.array([0.0, den_lo, FLT_MIN, den_hi, 0.5, hi,
                       np.nextafter(hi, np.float32(n_in))], np.float32)
    want = np.asarray(jsep.linear_resample_matrix(jnp.asarray(coords), n_in,
                                                  mask_oob=True))
    got = separable.linear_resample_matrix(torch.from_numpy(coords), n_in,
                                           mask_oob=True).numpy()
    np.testing.assert_array_equal(got, want)
    # rows 0, 1, 3 and 6 (0, both denormals, just above n-1) are masked
    assert not want[[0, 1, 3, 6]].any()
    assert want[[2, 4, 5]].sum(1).tolist() == [1.0, 1.0, 1.0]


def test_separable_and_gaussian_matrix_match_jax():
    """Matrix products in fp32 on both sides: tolerance for summation
    order (values O(1))."""
    from brainfm_tpu.ops import separable as jsep

    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 10, 11)).astype(np.float32)
    coords = [rng.uniform(0, n - 1, m).astype(np.float32)
              for n, m in zip(x.shape, (12, 7, 11))]
    want = jsep.separable_resample(jnp.asarray(x),
                                   [jnp.asarray(c) for c in coords])
    got = separable.separable_resample(torch.from_numpy(x),
                                       [torch.from_numpy(c) for c in coords])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for sigma in (0.0, 0.7, 2.3):
        np.testing.assert_allclose(
            separable.gaussian_matrix(torch.tensor(sigma), 13).numpy(),
            np.asarray(jsep.gaussian_matrix(jnp.float32(sigma), 13)),
            atol=1e-6)
    sig = np.array([0.0, 1.2, 2.0], np.float32)
    np.testing.assert_allclose(
        separable.separable_blur_matmul(torch.from_numpy(x),
                                        torch.from_numpy(sig)).numpy(),
        np.asarray(jsep.separable_blur_matmul(jnp.asarray(x),
                                              jnp.asarray(sig))),
        atol=1e-5)


@pytest.mark.parametrize("traced", [False, True])
def test_gaussian_blur_matches_jax(traced):
    """Concrete sigmas (exact reference kernels) and sigmas held in a
    tensor (masked fixed-width kernels); fp32 convolutions, tolerance for
    summation order."""
    from brainfm_tpu.ops import blur as jblur

    rng = np.random.default_rng(5)
    x = rng.standard_normal((10, 12, 14)).astype(np.float32)
    sig = [0.0, 0.8, 1.9]
    if traced:
        want = jblur.gaussian_blur_3d(jnp.asarray(x), jnp.asarray(sig,
                                      jnp.float32), max_sigma=4.0)
        got = blur.gaussian_blur_3d(torch.from_numpy(x),
                                    torch.tensor(sig), max_sigma=4.0)
    else:
        want = jblur.gaussian_blur_3d(jnp.asarray(x), sig)
        got = blur.gaussian_blur_3d(torch.from_numpy(x), sig)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
