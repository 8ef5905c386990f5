"""Randomized cross-backend equivalence: every fusion path, same bytes.

For random acquisition configurations, the host (NumPy + native C),
streaming (banded), device-XLA and mesh-sharded backends must produce
identical level-0 output. This is the strongest net against backend
drift.
"""

import glob
import os

import numpy as np
import pytest

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu import EngineOptions, stitch
from image_stitcher_tpu.io.zarr_store import open_zarr_array

CONFIGS = [
    # (cols, rows, tile_w, tile_h, overlap, channels, z, registration, ff,
    #  jitter)
    (3, 2, 96, 80, 24, 1, 1, False, False, 0),
    (2, 3, 64, 64, 16, 2, 2, True, False, 0),
    (4, 2, 128, 128, 32, 1, 1, True, True, 0),
    (2, 2, 80, 96, 16, 3, 1, False, True, 0),
    (3, 3, 96, 96, 32, 1, 3, True, False, 3),   # stage jitter, deep z
    (2, 4, 128, 64, 24, 2, 1, True, True, 2),   # non-square tiles + ff
]

BACKENDS = {
    "host": dict(fusion_device='host', streaming='off'),
    "streaming": dict(fusion_device='host', streaming='on',
                      chunks=(1, 1, 1, 64, 64)),
    "device_xla": dict(fusion_device='device', streaming='off'),
    "device_streaming": dict(fusion_device='device', streaming='on',
                             chunks=(1, 1, 1, 64, 64),
                             device_band_multiple=1),
    # taller HBM bands (fewer straddler re-ships): must stay identical
    "device_streaming_tall": dict(fusion_device='device', streaming='on',
                                  chunks=(1, 1, 1, 32, 64),
                                  device_band_multiple=2),
    "mesh": dict(mesh_shape=(1, 4), streaming='off'),
}


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_all_backends_identical(tmp_path, cfg):
    cols, rows, tw, th, ov, nch, nz, reg, ff, jitter = cfg
    channels = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex",
                "Fluorescence 561 nm Ex"][:nch]
    results = {}
    for name, opts in BACKENDS.items():
        acq_dir = str(tmp_path / f"{name}")
        write_synthetic_acquisition(
            acq_dir, grid_cols=cols, grid_rows=rows, tile_w=tw, tile_h=th,
            overlap=ov, channels=channels, num_z=nz, seed=hash(cfg) % 1000,
            jitter=jitter,
            acq_params_overrides={"pixel_binning": 2})
        stitch(acq_dir, use_registration=reg, apply_flatfield=ff,
               options=EngineOptions(**opts))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        results[name] = np.asarray(open_zarr_array(os.path.join(
            out, "0_stitched", "A1_stitched.ome.zarr", "0")).read().result())
    ref = results.pop("host")
    for name, data in results.items():
        np.testing.assert_array_equal(data, ref, err_msg=name)


@pytest.mark.parametrize("use_registration", [False, True])
def test_feather_backends_agree(tmp_path, use_registration):
    """Feather blending must agree across host/streaming/device — in
    particular at canvas-edge overlaps, where clamped windows must not
    change blend weights (regression for the ramp-divergence finding)."""
    feather_backends = {
        "host": dict(fusion_device='host', streaming='off'),
        "streaming": dict(fusion_device='host', streaming='on',
                          chunks=(1, 1, 1, 64, 64)),
        "device": dict(fusion_device='device', streaming='off'),
        "device_streaming": dict(fusion_device='device', streaming='on',
                                 chunks=(1, 1, 1, 64, 64)),
        "mesh": dict(mesh_shape=(1, 4), streaming='off'),
    }
    results = {}
    for name, opts in feather_backends.items():
        acq_dir = str(tmp_path / f"f{use_registration}_{name}")
        write_synthetic_acquisition(
            acq_dir, grid_cols=3, grid_rows=3, tile_w=96, tile_h=96,
            overlap=40, seed=9, jitter=3 if use_registration else 0,
            acq_params_overrides={"pixel_binning": 2})
        stitch(acq_dir, use_registration=use_registration,
               options=EngineOptions(blend_method='feather', feather_px=24,
                                     **opts))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        results[name] = np.asarray(open_zarr_array(os.path.join(
            out, "0_stitched", "A1_stitched.ome.zarr", "0")).read().result())
    ref = results.pop("host").astype(int)
    for name, data in results.items():
        diff = np.abs(data.astype(int) - ref)
        assert diff.max() <= 1, (name, diff.max())  # f32 accumulation order
