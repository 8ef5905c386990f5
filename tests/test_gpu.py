"""Device kernels on the card against their host references.

Marked ``gpu``: each test takes the ``gpu_device`` fixture (conftest),
which skips it where jax finds no GPU. On the GPU host run them with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``; chip_smoke.py runs
them in its own process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_stitcher_tpu.ops.fuse import (apply_flatfield, finalize_feather,
                                         fuse_feather, fuse_overwrite,
                                         padded_canvas_shape)
from image_stitcher_tpu.ops.phasecorr import (
    _pcc_np, phase_cross_correlation_conf_batch)
from image_stitcher_tpu.ops.pyramid import downsample

from test_fuse_reference import correct_ref, feather_ref, overwrite_ref

pytestmark = pytest.mark.gpu

TILE = 2048


def _tiles_2048(n=6, C=3):
    rng = np.random.default_rng(0)
    H = W = 2 * TILE + 300
    tiles = rng.integers(0, 65535, (n, TILE, TILE), dtype=np.uint16)
    info = np.stack([rng.integers(0, C, n), np.zeros(n, int),
                     rng.integers(0, H - TILE, n),
                     rng.integers(0, W - TILE, n)], axis=1).astype(np.int32)
    crops = rng.integers(0, 200, (n, 4)).astype(np.int32)
    valid = np.ones(n, bool)
    ff = (rng.random((C, TILE, TILE)) * 0.8 + 0.6).astype(np.float32)
    return C, H, W, tiles, info, crops, valid, ff


def test_device_overwrite_with_flatfield_matches_host_2048(gpu_device):
    """apply_flatfield + fuse_overwrite on the card, 2048^2 tiles: byte
    for byte the NumPy correction and slice-assign."""
    C, H, W, tiles, info, crops, valid, ff = _tiles_2048()
    put = lambda x: jax.device_put(x, gpu_device)  # noqa: E731
    corrected = apply_flatfield(put(tiles), put(ff), put(info[:, 0]),
                                jnp.uint16)
    ref_tiles = correct_ref(tiles, ff, info[:, 0], np.uint16)
    np.testing.assert_array_equal(np.asarray(corrected), ref_tiles)
    canvas = put(np.zeros(padded_canvas_shape(C, 1, H, W, TILE, TILE),
                          np.uint16))
    canvas = fuse_overwrite(canvas, corrected, put(info), put(crops),
                            put(valid))
    np.testing.assert_array_equal(
        np.asarray(canvas)[:, :, :H, :W],
        overwrite_ref(C, 1, H, W, ref_tiles, info, crops, valid))


def test_device_feather_matches_host_2048(gpu_device):
    """f32 feather accumulators and the device divide in finalize_feather
    against the NumPy feather reference: within 1 LSB."""
    C, H, W, tiles, info, crops, valid, _ = _tiles_2048()
    put = lambda x: jax.device_put(x, gpu_device)  # noqa: E731
    shp = padded_canvas_shape(C, 1, H, W, TILE, TILE)
    acc, wsum = fuse_feather(put(np.zeros(shp, np.float32)),
                             put(np.zeros(shp, np.float32)), put(tiles),
                             put(info), put(crops), put(valid), blend_px=64)
    got = np.asarray(finalize_feather(acc, wsum, jnp.uint16))[:, :, :H, :W]
    expect = feather_ref(C, 1, H, W, tiles, info, crops, valid, 64)
    diff = np.abs(got.astype(np.int64) - expect.astype(np.int64))
    assert diff.max() <= 1


def test_device_pyramid_matches_host(gpu_device):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 65535, (3, 1, 4097, 3001), dtype=np.uint16)
    for mode in ('nearest', 'mean'):
        got = np.asarray(downsample(jax.device_put(x, gpu_device), mode))
        if mode == 'nearest':
            expect = x[..., :4096:2, :3000:2]
        else:
            expect = np.trunc(x[..., :4096, :3000].astype(np.float32)
                              .reshape(3, 1, 2048, 2, 1500, 2)
                              .mean(axis=(3, 5))).astype(np.uint16)
        np.testing.assert_array_equal(got, expect)


def test_phasecorr_highest_precision_matches_f64_twin(gpu_device):
    """The batched kernel at W1 strip size, fractional shifts: within
    0.1 px of the float64 twin (the registration target)."""
    rng = np.random.default_rng(2)
    n, h, w = 32, 1024, 215
    truth = rng.uniform(-4, 4, (n, 2))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    base = rng.random((n, h, w))
    moved = np.stack([np.real(np.fft.ifft2(np.fft.fft2(base[i]) * np.exp(
        -2j * np.pi * (fy * truth[i, 0] + fx * truth[i, 1]))))
        for i in range(n)])
    a = base.astype(np.float32)
    b = moved.astype(np.float32)
    got, _ = phase_cross_correlation_conf_batch(
        jax.device_put(a, gpu_device), jax.device_put(b, gpu_device), 10)
    ref = np.stack([_pcc_np(a[i], b[i], 10)[0] for i in range(n)])
    np.testing.assert_allclose(np.asarray(got), ref, atol=0.1)
    np.testing.assert_allclose(ref, -truth, atol=0.1)
