import glob
import os

import numpy as np

from image_stitcher_tpu import EngineOptions, stitch
from image_stitcher_tpu.io.zarr_store import open_zarr_array
from image_stitcher_tpu.ops.host_fuse import HostCanvas, host_downsample
from image_stitcher_tpu.ops.pyramid import downsample
import jax.numpy as jnp

from fixtures import write_synthetic_acquisition


def test_host_canvas_matches_reference_semantics(rng):
    H = W = 64
    hc = HostCanvas(2, 1, H, W, np.uint16, num_threads=4)
    ref = np.zeros((2, 1, H, W), np.uint16)
    jobs = []
    for i in range(12):
        tile = rng.integers(0, 65535, (16, 16), dtype=np.uint16)
        c = int(rng.integers(0, 2))
        y, x = int(rng.integers(0, H - 4)), int(rng.integers(0, W - 4))
        crops = tuple(int(v) for v in rng.integers(0, 4, 4))
        jobs.append((tile, c, 0, y, x, crops))
        top, bottom, left, right = crops
        t = tile[top:16 - bottom if bottom else 16,
                 left:16 - right if right else 16]
        yy, xx = y + top, x + left
        ye, xe = min(yy + t.shape[0], H), min(xx + t.shape[1], W)
        ref[c, 0, yy:ye, xx:xe] = t[:ye - yy, :xe - xx]
    hc.fuse(jobs)
    np.testing.assert_array_equal(hc.finalize(), ref)


def test_host_canvas_flatfield():
    # correction multiplies by the reciprocal field: recip 0.5 == /2
    hc = HostCanvas(1, 1, 8, 8, np.uint16,
                    ff_recip=np.full((1, 4, 4), 0.5, np.float32))
    hc.fuse([(np.full((4, 4), 1000, np.uint16), 0, 0, 0, 0, (0, 0, 0, 0))])
    out = hc.finalize()
    assert out[0, 0, 0, 0] == 500


def test_host_downsample_matches_device(rng):
    x = rng.integers(0, 65535, (1, 2, 1, 33, 47), dtype=np.uint16)
    for mode in ('nearest', 'mean'):
        np.testing.assert_array_equal(
            host_downsample(x, mode), np.asarray(downsample(jnp.asarray(x), mode)))


def test_host_downsample_out_strided_columns(rng):
    """out= fills strided column slices of a pooled band byte-identically
    to the concatenate-of-copies path it replaces (streaming.py block
    banding), for both kernels and both dtypes."""
    import pytest
    for dtype in (np.uint16, np.uint8):
        hi = np.iinfo(dtype).max
        blocks = rng.integers(0, hi, (3, 34, 48), dtype=dtype)
        for mode in ('nearest', 'mean'):
            ref = np.concatenate([host_downsample(blocks[i], mode)
                                  for i in range(3)], axis=1)
            pool = np.zeros((17, 3 * 24 + 5), dtype)  # wider than needed
            for i in range(3):
                got = host_downsample(blocks[i], mode,
                                      out=pool[:, i * 24:(i + 1) * 24])
                assert got.base is pool or got is pool
            np.testing.assert_array_equal(pool[:, :72], ref)
    # float falls through to the NumPy mean path; out must still be honored
    xf = rng.random((10, 12)).astype(np.float32)
    outf = np.empty((5, 6), np.float32)
    assert host_downsample(xf, 'mean', out=outf) is outf
    np.testing.assert_array_equal(outf, host_downsample(xf, 'mean'))
    # mismatched out is an error, never silently ignored
    with pytest.raises(ValueError):
        host_downsample(xf, 'mean', out=np.empty((4, 6), np.float32))
    with pytest.raises(ValueError):
        host_downsample(xf, 'mean', out=np.empty((5, 6), np.float64))


def test_host_vs_device_e2e_identical(tmp_path):
    """The two fusion backends must produce byte-identical zarr output."""
    results = {}
    for backend in ('host', 'device'):
        acq_dir = str(tmp_path / f"acq_{backend}")
        write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=2,
                                    tile_w=96, tile_h=96, overlap=24,
                                    channels=["Fluorescence 488 nm Ex",
                                              "Fluorescence 561 nm Ex"],
                                    num_z=2)
        stitch(acq_dir, options=EngineOptions(fusion_device=backend,
                                              fusion_batch=5))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        zp = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr", "0")
        results[backend] = np.asarray(open_zarr_array(zp).read().result())
    np.testing.assert_array_equal(results['host'], results['device'])


def test_host_feather_close_to_device(tmp_path):
    results = {}
    for backend in ('host', 'device'):
        acq_dir = str(tmp_path / f"f_{backend}")
        write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                    tile_w=64, tile_h=64, overlap=16)
        stitch(acq_dir, options=EngineOptions(fusion_device=backend,
                                              blend_method='feather'))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        zp = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr", "0")
        results[backend] = np.asarray(open_zarr_array(zp).read().result())
    diff = np.abs(results['host'].astype(int) - results['device'].astype(int))
    assert diff.max() <= 1  # f32 accumulation rounding only


def test_correct_tile_undersized_numpy_fallback():
    """The NumPy twin must correct an undersized edge tile by the
    matching window of the nominal-size reciprocal field (it used to
    raise a broadcast ValueError when the native kernel was absent)."""
    from image_stitcher_tpu.ops.host_fuse import correct_tile
    rng = np.random.default_rng(3)
    ff = (rng.random((2, 64, 64)) * 0.8 + 0.6).astype(np.float32)
    tile = rng.integers(0, 65535, (48, 40), dtype=np.uint16)
    out = correct_tile(tile, ff, 1, np.dtype(np.uint16))
    assert out.shape == (48, 40)
    expect = np.clip(tile * ff[1][:48, :40], 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(out, expect)
