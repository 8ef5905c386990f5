"""Round-2 regression tests: mmap reads, flatfield sampling rework,
undersized-tile crop folding, streaming native placement."""

import glob
import os

import numpy as np
import pytest

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu import EngineOptions, stitch
from image_stitcher_tpu.io.zarr_store import open_zarr_array


def _shrink_fov(acq_dir: str, fov: int) -> str:
    """Shrink the tile with a specific fov number (filename sort is
    lexicographic, so positional indexing lies for fov >= 10)."""
    import cv2
    path = sorted(glob.glob(os.path.join(acq_dir, "0",
                                         f"A1_{fov}_*.tiff")))[0]
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    small = np.ascontiguousarray(img[: img.shape[0] * 3 // 4,
                                     : img.shape[1] * 3 // 4])
    assert cv2.imwrite(path, small, [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])
    return path


def _shrink_one_tile(acq_dir: str, index: int = -1) -> str:
    """Rewrite one tile file with its bottom/right quarter cut off.

    Defaults to the LAST (corner) tile: with registration on, its
    interior edges carry real crops, exercising the crop-plus-deficit
    fold that keeps device backends equal to the host's actual-shape
    slicing. (Never the first tile — the acquisition probes nominal
    dims from it, reference parity, so shrinking it redefines the
    whole geometry rather than degrading one tile.)"""
    import cv2
    tiles = sorted(glob.glob(os.path.join(acq_dir, "0", "*.tiff")))
    path = tiles[index]
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    small = np.ascontiguousarray(img[: img.shape[0] * 3 // 4,
                                     : img.shape[1] * 3 // 4])
    flags = [int(cv2.IMWRITE_TIFF_COMPRESSION), 1]
    assert cv2.imwrite(path, small, flags)
    return path


def _read_level0(acq_dir: str) -> np.ndarray:
    out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
    return np.asarray(open_zarr_array(os.path.join(
        out, "0_stitched", "A1_stitched.ome.zarr", "0")).read().result())


def test_mmap_read_matches_copy_read(tmp_path):
    from image_stitcher_tpu.io.fast_tiff import read_tiff_fast
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=96, tile_h=80, overlap=16)
    for path in glob.glob(os.path.join(acq_dir, "0", "*.tiff")):
        a = read_tiff_fast(path)
        b = read_tiff_fast(path, use_mmap=True)
        assert a is not None and b is not None
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_undersized_tile_backends_agree(tmp_path):
    """A tile smaller than nominal must fuse identically on the host
    (slices by actual shape) and device (zero-padded batch + folded
    crops) backends — regression for the padding-overwrites finding."""
    results = {}
    for name, opts in {
        "host": dict(fusion_device='host', streaming='off'),
        "streaming": dict(fusion_device='host', streaming='on',
                          chunks=(1, 1, 1, 64, 64)),
        "device": dict(fusion_device='device', streaming='off'),
        "device_streaming": dict(fusion_device='device', streaming='on',
                                 chunks=(1, 1, 1, 64, 64)),
    }.items():
        acq_dir = str(tmp_path / name)
        write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=2,
                                    tile_w=96, tile_h=96, overlap=32,
                                    seed=4)
        # fov 4 = (row 1, col 1): its RIGHT crop is interior (nonzero),
        # so the fold must ADD the deficit to it (max() would differ)
        _shrink_one_tile(acq_dir, index=4)
        stitch(acq_dir, use_registration=True,
               options=EngineOptions(**opts))
        results[name] = _read_level0(acq_dir)
    ref = results.pop("host")
    for name, data in results.items():
        np.testing.assert_array_equal(data, ref, err_msg=name)


def test_undersized_tile_feather_backends_agree(tmp_path):
    """Feather ramps must measure from the ACTUAL loaded tile shape on
    every backend (streaming previously used the nominal shape)."""
    results = {}
    for name, opts in {
        "host": dict(fusion_device='host', streaming='off'),
        "streaming": dict(fusion_device='host', streaming='on',
                          chunks=(1, 1, 1, 64, 64)),
    }.items():
        acq_dir = str(tmp_path / f"fe_{name}")
        write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=2,
                                    tile_w=96, tile_h=96, overlap=32,
                                    seed=5)
        _shrink_one_tile(acq_dir, index=4)
        stitch(acq_dir, use_registration=True, options=EngineOptions(
            blend_method='feather', feather_px=24, **opts))
        results[name] = _read_level0(acq_dir)
    diff = np.abs(results["host"].astype(int) - results["streaming"].astype(int))
    assert diff.max() <= 1  # f32 accumulation order


def test_allpairs_drops_truncated_tile_pairs(tmp_path):
    """Pairs touching a truncated tile must not feed zero-padded strips
    to the correlator; they are dropped (grid model covers the cell)
    and the aggregate shifts stay correct."""
    from image_stitcher_tpu import StitchingParameters
    from image_stitcher_tpu.models.pipeline import StitchPipeline
    from image_stitcher_tpu.io.acquisition import scan_acquisition
    from image_stitcher_tpu.utils.progress import ProgressReporter
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=4, grid_rows=3,
                                tile_w=96, tile_h=96, overlap=32, seed=7,
                                acq_params_overrides={"pixel_binning": 2})
    _shrink_fov(acq_dir, 5)  # (row 1, col 1): interior, 4 pairs affected
    msgs = []
    p = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe = StitchPipeline(
        p, EngineOptions(registration_scope='all-pairs'),
        reporter=ProgressReporter(status=lambda m, s=False: msgs.append(m)))
    pipe.acq = scan_acquisition(acq_dir)
    pipe.calculate_shifts_all_pairs(0, "A1")
    assert any("truncated tiles" in m for m in msgs)
    # remaining pairs still aggregate to the true grid overlap
    assert pipe.shifts.h_shift == (0, -32)
    assert pipe.shifts.v_shift == (-32, 0)
    # the dropped pairs are absent from the measurement record
    n_h = len(pipe.pair_shifts['h_keys'])
    n_v = len(pipe.pair_shifts['v_keys'])
    assert n_h == 3 * 3 - 2  # 3 pairs/row x 3 rows, 2 touch the bad tile
    assert n_v == 4 * 2 - 2  # 4 cols x 2, 2 touch the bad tile


def test_global_solve_canvas_clamp(tmp_path, monkeypatch):
    """A confidently-wrong pair chain must not balloon the canvas: the
    flying tile's constraints are dropped (it degrades to the grid
    model) while the REST of the region keeps its global positions
    (VERDICT r4 #7 partial rejection)."""
    from image_stitcher_tpu.ops import globalopt
    real_solve = globalopt.solve_positions

    def bad_solve(pairs, n, **kw):
        pos = real_solve(pairs, n, **kw)
        pos = np.asarray(pos).copy()
        pos[-1] += 50000.0  # one tile flies off the canvas
        return pos

    monkeypatch.setattr(globalopt, "solve_positions", bad_solve)
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                tile_w=96, tile_h=96, overlap=32, jitter=2,
                                acq_params_overrides={"pixel_binning": 2})
    msgs = []
    from image_stitcher_tpu.utils.progress import ProgressReporter
    from image_stitcher_tpu import StitchingParameters
    from image_stitcher_tpu.models.pipeline import StitchPipeline
    p = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe = StitchPipeline(
        p, EngineOptions(registration_scope='global'),
        reporter=ProgressReporter(status=lambda m, s=False: msgs.append(m)))
    pipe.run()
    # partial rejection: the flyer (last tile, (2,2)) lost its global
    # position; every other tile kept one
    region_pos = pipe.global_positions.get("A1", {})
    assert region_pos and (2, 2) not in region_pos
    assert len(region_pos) == 8
    assert any("dropped" in m and "constraint" in m for m in msgs)
    # canvas stayed grid-sized (not 50000+ px)
    arr = _read_level0(acq_dir)
    assert arr.shape[-1] < 1000 and arr.shape[-2] < 1000
    assert (arr != 0).mean() > 0.5


def test_global_solve_wholesale_fallback(tmp_path, monkeypatch):
    """When the corruption exceeds the drop budget (every tile flying),
    the region falls back to the grid shift model wholesale."""
    from image_stitcher_tpu.ops import globalopt
    real_solve = globalopt.solve_positions

    def bad_solve(pairs, n, **kw):
        pos = real_solve(pairs, n, **kw)
        pos = np.asarray(pos).copy()
        pos[::2] += 50000.0  # half the grid flies: beyond any budget
        return pos

    monkeypatch.setattr(globalopt, "solve_positions", bad_solve)
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                tile_w=96, tile_h=96, overlap=32, jitter=2,
                                acq_params_overrides={"pixel_binning": 2})
    msgs = []
    from image_stitcher_tpu.utils.progress import ProgressReporter
    from image_stitcher_tpu import StitchingParameters
    from image_stitcher_tpu.models.pipeline import StitchPipeline
    p = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe = StitchPipeline(
        p, EngineOptions(registration_scope='global'),
        reporter=ProgressReporter(status=lambda m, s=False: msgs.append(m)))
    pipe.run()
    assert not pipe.global_positions
    assert any("exceeds the stage extent" in m for m in msgs)
    arr = _read_level0(acq_dir)
    assert arr.shape[-1] < 1000 and arr.shape[-2] < 1000
    assert (arr != 0).mean() > 0.5


def test_zarr3_sharded_roundtrip(tmp_path):
    """zarr v3 sharding_indexed arrays round-trip with the Y-thin,
    X-wide shard layout (one chunk row tall, up to 16 chunks wide): the
    file-count fix at 12k-24k canvases that band-streaming writes still
    cover with WHOLE shards (no level-0 shard read-modify-write)."""
    import json

    from image_stitcher_tpu.io.zarr_store import (create_zarr3_sharded_array,
                                                  open_zarr_array)
    import tensorstore as ts
    rng = np.random.default_rng(0)
    data = rng.integers(0, 65535, (1, 2, 1, 256, 256), np.uint16)
    path = str(tmp_path / "v3.zarr")
    arr = create_zarr3_sharded_array(path, data.shape, (1, 1, 1, 64, 64),
                                     np.uint16)
    arr.write(data).result()
    back = ts.open({'driver': 'zarr3',
                    'kvstore': {'driver': 'file', 'path': path}},
                   open=True).result()
    np.testing.assert_array_equal(np.asarray(back.read().result()), data)
    # shard (write) chunk: one read-chunk row tall, full width here
    with open(os.path.join(path, 'zarr.json')) as f:
        meta = json.load(f)
    assert meta['chunk_grid']['configuration']['chunk_shape'] == \
        [1, 1, 1, 64, 256]
    codec = meta['codecs'][0]
    assert codec['name'] == 'sharding_indexed'
    assert codec['configuration']['chunk_shape'] == [1, 1, 1, 64, 64]
    # 1x4 read chunks per shard: 4 Y-shards x 2 channels = 8 data files
    # (+ zarr.json)
    n_files = sum(len(fs) for _, _, fs in os.walk(path))
    assert n_files <= 9


def test_zarr3_band_write_is_whole_shards(tmp_path):
    """A full-width band write one chunk-row tall rewrites exactly its
    own shard files and no others (the band-streaming access pattern;
    a 4x4 shard layout would read-modify-write each shard 4x)."""
    from image_stitcher_tpu.io.zarr_store import create_zarr3_sharded_array
    path = str(tmp_path / "v3b.zarr")
    arr = create_zarr3_sharded_array(path, (1, 1, 1, 256, 512),
                                     (1, 1, 1, 64, 64), np.uint16)
    rng = np.random.default_rng(1)

    def data_files():
        out = {}
        for r, _, fs in os.walk(path):
            for f in fs:
                if f != 'zarr.json':
                    p = os.path.join(r, f)
                    out[p] = os.path.getmtime(p)
        return out

    band0 = rng.integers(0, 65535, (1, 1, 1, 64, 512), np.uint16)
    arr[:, :, :, 0:64, :].write(band0).result()
    after_first = data_files()
    assert len(after_first) == 1  # one shard row covers the whole band
    import time
    time.sleep(0.02)
    band1 = rng.integers(0, 65535, (1, 1, 1, 64, 512), np.uint16)
    arr[:, :, :, 64:128, :].write(band1).result()
    after_second = data_files()
    assert len(after_second) == 2
    # the first band's shard was not rewritten by the second band
    (first_path, first_mtime), = after_first.items()
    assert after_second[first_path] == first_mtime


def test_zarr_v3_ngff05_output(tmp_path):
    """zarr_format=3 writes OME-NGFF 0.5 on zarr v3 sharded storage:
    same pixels as the v2 tree, 'ome'-wrapped attrs, far fewer files."""
    from image_stitcher_tpu.io.zarr_store import open_zarr_array, read_attrs
    results = {}
    trees = {}
    for zf in (2, 3):
        acq_dir = str(tmp_path / f"v{zf}")
        write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                    tile_w=96, tile_h=96, overlap=24, seed=3)
        stitch(acq_dir, use_registration=True,
               options=EngineOptions(zarr_format=zf,
                                     chunks=(1, 1, 1, 64, 64)))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        z = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr")
        results[zf] = np.asarray(
            open_zarr_array(os.path.join(z, "0")).read().result())
        trees[zf] = z
    np.testing.assert_array_equal(results[3], results[2])
    attrs = read_attrs(trees[3])
    assert attrs["ome"]["version"] == "0.5"
    ms = attrs["ome"]["multiscales"][0]
    assert [a["name"] for a in ms["axes"]] == list("tczyx")
    assert "version" not in ms  # 0.5 carries the version at group level
    assert attrs["ome"]["omero"]["channels"]
    assert os.path.exists(os.path.join(trees[3], "zarr.json"))
    n2 = sum(len(f) for _, _, f in os.walk(trees[2]))
    n3 = sum(len(f) for _, _, f in os.walk(trees[3]))
    assert n3 < n2


def test_zarr_v3_streaming_and_merges(tmp_path):
    """v3 output through the streaming fuser and the HCS merge tree."""
    from image_stitcher_tpu.io.zarr_store import open_zarr_array, read_attrs
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                tile_w=96, tile_h=96, overlap=24,
                                regions=["B2", "C3"], seed=6)
    acq_dir2 = str(tmp_path / "acq2")
    write_synthetic_acquisition(acq_dir2, grid_cols=2, grid_rows=2,
                                tile_w=96, tile_h=96, overlap=24,
                                regions=["B2", "C3"], seed=6)
    stitch(acq_dir, merge_hcs_regions=True,
           options=EngineOptions(zarr_format=3, streaming='on',
                                 chunks=(1, 1, 1, 32, 32)))
    stitch(acq_dir2, merge_hcs_regions=True,
           options=EngineOptions(zarr_format=2, streaming='on',
                                 chunks=(1, 1, 1, 32, 32)))
    out3 = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
    out2 = sorted(glob.glob(acq_dir2 + "_stitched_*"))[-1]
    plate3 = os.path.join(out3, "hcs_timepoints", "0_hcs.ome.zarr")
    plate2 = os.path.join(out2, "hcs_timepoints", "0_hcs.ome.zarr")
    p_attrs = read_attrs(plate3)
    assert p_attrs["ome"]["version"] == "0.5"
    assert p_attrs["ome"]["plate"]["wells"] == \
        read_attrs(plate2)["plate"]["wells"]
    w_attrs = read_attrs(os.path.join(plate3, "B", "2"))
    assert w_attrs["ome"]["well"]["images"] == [
        {"path": "0", "acquisition": 0}]
    a3 = np.asarray(open_zarr_array(
        os.path.join(plate3, "B", "2", "0", "0")).read().result())
    a2 = np.asarray(open_zarr_array(
        os.path.join(plate2, "B", "2", "0", "0")).read().result())
    np.testing.assert_array_equal(a3, a2)


def test_flatfield_device_matches_host(tmp_path):
    """flatfield_device='device' (jitted solver) fits the same sample
    stack as the host twin, so the fields agree to solver precision."""
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                tile_w=64, tile_h=64, overlap=16,
                                vignette=0.35, seed=7)
    fields = {}
    for mode in ("host", "device"):
        from image_stitcher_tpu import StitchingParameters
        from image_stitcher_tpu.models.pipeline import StitchPipeline
        from image_stitcher_tpu.io.acquisition import scan_acquisition
        p = StitchingParameters(input_folder=acq_dir, apply_flatfield=True)
        pipe = StitchPipeline(p, EngineOptions(flatfield_device=mode))
        pipe.acq = scan_acquisition(acq_dir)
        pipe.compute_flatfields()
        fields[mode] = pipe.flatfields[0]
    # same model on the same stack: only f32 reduction order differs
    a, b = fields["host"], fields["device"]
    np.testing.assert_allclose(a, b, atol=1e-3)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.98


def test_compressor_auto(tmp_path, monkeypatch):
    """'auto' stores raw chunks for incompressible content and keeps
    blosc for compressible content on a disk-bound host — one decision
    per run, applied to region writers and merges alike. The disk probe
    is pinned slow here so the decision under test is the content gate
    (the disk gate has its own test)."""
    import json

    from fixtures import write_synthetic_acquisition
    from image_stitcher_tpu import EngineOptions, stitch
    from image_stitcher_tpu.models.pipeline import StitchPipeline

    monkeypatch.setattr(StitchPipeline, '_probed_disk_mbps',
                        lambda self: 120.0)

    # random uint16 texture: incompressible -> raw
    acq1 = str(tmp_path / "noise")
    write_synthetic_acquisition(acq1, grid_cols=2, grid_rows=1,
                                tile_w=64, tile_h=64, overlap=16)
    pipe = stitch(acq1, options=EngineOptions(compressor_cname='auto'))
    out = sorted(glob.glob(acq1 + "_stitched_*"))[-1]
    with open(os.path.join(out, "0_stitched", "A1_stitched.ome.zarr",
                           "0", ".zarray")) as f:
        assert json.load(f)["compressor"] is None
    assert pipe.resolved_compressor()[0] is None

    # dark gamma-skewed content with flat background: compressible
    acq2 = str(tmp_path / "dark")
    write_synthetic_acquisition(acq2, grid_cols=2, grid_rows=1,
                                tile_w=64, tile_h=64, overlap=16,
                                gt_gamma=40.0)
    stitch(acq2, options=EngineOptions(compressor_cname='auto'))
    out = sorted(glob.glob(acq2 + "_stitched_*"))[-1]
    with open(os.path.join(out, "0_stitched", "A1_stitched.ome.zarr",
                           "0", ".zarray")) as f:
        comp = json.load(f)["compressor"]
    assert comp is not None and comp["id"] == "blosc"

    # raw output must round-trip identically
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    data = np.asarray(open_zarr_array(os.path.join(
        sorted(glob.glob(acq1 + "_stitched_*"))[-1], "0_stitched",
        "A1_stitched.ome.zarr", "0")).read().result())
    assert data.max() > 0
