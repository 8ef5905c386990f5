"""Round-3 regression tests: ADVICE r2 fixes + VERDICT r2 items.

- merge unit completeness is decided by manifests (not bare isdir)
- GUI stop-vs-complete race uses an explicit flag (not path compare)
- compressor 'auto' probes several tiles and takes the median
"""

import glob
import json
import os
import queue as queue_mod
import types

import numpy as np
from fixtures import write_synthetic_acquisition

os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")


# ------------------------------------------------------------ merge units


def _fake_pipeline(tmp_path):
    pipe = types.SimpleNamespace()
    pipe.output_folder = str(tmp_path)
    pipe.output_format = ".ome.zarr"
    return pipe


def _make_store_dir(tmp_path, t, region, with_metadata):
    level0 = os.path.join(str(tmp_path), f"{t}_stitched",
                          f"{region}_stitched.ome.zarr", "0")
    os.makedirs(level0, exist_ok=True)
    if with_metadata:
        with open(os.path.join(level0, ".zarray"), "w") as f:
            json.dump({"shape": [1]}, f)


def test_unit_exists_requires_manifest_completion(tmp_path):
    """A partially-written store (dir exists, unit not in any manifest's
    completed list) must NOT count as mergeable (ADVICE r2 #1)."""
    from image_stitcher_tpu.models.merge import _unit_exists
    from image_stitcher_tpu.utils.manifest import MANIFEST_NAME

    pipe = _fake_pipeline(tmp_path)
    _make_store_dir(tmp_path, 0, "A1", with_metadata=True)
    _make_store_dir(tmp_path, 0, "A2", with_metadata=True)  # died mid-save
    with open(os.path.join(str(tmp_path), MANIFEST_NAME), "w") as f:
        json.dump({"completed": ["0/A1"]}, f)

    assert _unit_exists(pipe, 0, "A1")
    assert not _unit_exists(pipe, 0, "A2")


def test_unit_exists_unions_shard_manifests(tmp_path):
    """Under work sharding the coordinator must see every shard's
    completed units, not only its own manifest's."""
    from image_stitcher_tpu.models.merge import _unit_exists
    from image_stitcher_tpu.utils.manifest import MANIFEST_NAME

    pipe = _fake_pipeline(tmp_path)
    _make_store_dir(tmp_path, 0, "A1", with_metadata=True)
    _make_store_dir(tmp_path, 0, "A2", with_metadata=True)
    with open(os.path.join(str(tmp_path), MANIFEST_NAME + ".shard0"),
              "w") as f:
        json.dump({"completed": ["0/A1"]}, f)
    with open(os.path.join(str(tmp_path), MANIFEST_NAME + ".shard1"),
              "w") as f:
        json.dump({"completed": ["0/A2"]}, f)

    assert _unit_exists(pipe, 0, "A1")
    assert _unit_exists(pipe, 0, "A2")
    assert not _unit_exists(pipe, 0, "B1")


def test_unit_exists_standalone_falls_back_to_metadata(tmp_path):
    """No manifest at all (standalone merge over an existing tree):
    presence of the level-0 array metadata decides — a store that died
    before array creation is excluded."""
    from image_stitcher_tpu.models.merge import _unit_exists

    pipe = _fake_pipeline(tmp_path)
    _make_store_dir(tmp_path, 0, "A1", with_metadata=True)
    _make_store_dir(tmp_path, 0, "A2", with_metadata=False)

    assert _unit_exists(pipe, 0, "A1")
    assert not _unit_exists(pipe, 0, "A2")


# ----------------------------------------------------------- GUI stop race


class _StubStitcher:
    """Dead-on-arrival child with live queues for _drain_queues."""

    def __init__(self):
        self.progress_queue = queue_mod.Queue()
        self.status_queue = queue_mod.Queue()
        self.complete_queue = queue_mod.Queue()
        self.stopped = False

    def request_stop(self):
        self.stopped = True

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass

    def terminate(self):
        pass


def test_gui_stop_after_rerun_same_path_says_stopped(qapp=None):
    """ADVICE r2 #2: a re-run of the same acquisition completing into
    the SAME output path used to defeat the old path-comparison check.
    After a fresh start (no complete yet), stop must say 'Stopped' even
    though self.output_path still holds the previous run's (identical)
    path."""
    from image_stitcher_tpu import qt_compat
    from image_stitcher_tpu.gui import StitchingGUI

    app = qt_compat.QApplication.instance() or qt_compat.QApplication([])
    del app
    gui = StitchingGUI()

    # previous run completed into P
    gui.stitcher = _StubStitcher()
    gui.stitcher.complete_queue.put(("complete", ("/out/P", "uint16")))
    gui._run_complete = False
    gui._drain_queues(gui.stitcher)
    assert gui._run_complete and gui.output_path == "/out/P"

    # new run into the same path; user stops before completion
    gui.stitcher = _StubStitcher()
    gui._run_complete = False  # what start_stitching() resets
    gui.stop_stitching()
    assert gui.status_label.text() == "Stopped"
    # the viewer may stay enabled — the PREVIOUS run's completed output
    # is still on disk and viewable; only the status must say Stopped


def test_gui_stop_keeps_complete_when_child_finished():
    """Converse: a 'complete' that lands during the stop wait keeps the
    Complete status and viewer access."""
    from image_stitcher_tpu import qt_compat
    from image_stitcher_tpu.gui import StitchingGUI

    app = qt_compat.QApplication.instance() or qt_compat.QApplication([])
    del app
    gui = StitchingGUI()
    gui.stitcher = _StubStitcher()
    gui._run_complete = False
    gui.stitcher.complete_queue.put(("complete", ("/out/P", "uint16")))
    gui.stop_stitching()
    assert "Complete" in gui.status_label.text()
    assert gui.view_btn.isEnabled()


# ------------------------------------------------------- compressor probe


def test_compressor_auto_median_survives_one_noisy_tile(tmp_path,
                                                        monkeypatch):
    """ADVICE r2 #3: one incompressible tile on an otherwise
    compressible plate must not commit the run to raw storage — the
    decision is the MEDIAN of first/center/last probes. Disk probe
    pinned slow so the content gate is what's under test."""
    from image_stitcher_tpu import EngineOptions, StitchingParameters
    from image_stitcher_tpu.io.acquisition import scan_acquisition
    from image_stitcher_tpu.models.pipeline import StitchPipeline

    monkeypatch.setattr(StitchPipeline, '_probed_disk_mbps',
                        lambda self: 120.0)
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=1,
                                tile_w=64, tile_h=64, overlap=16,
                                gt_gamma=40.0)  # compressible content

    p = StitchingParameters(input_folder=acq_dir)
    pipe = StitchPipeline(p, EngineOptions(compressor_cname='auto'))
    pipe.acq = scan_acquisition(acq_dir)

    # poison the FIRST tile in key order with pure noise
    import cv2
    from image_stitcher_tpu.io.acquisition import read_image
    keys = sorted(pipe.acq.tiles.keys())
    first = pipe.acq.tiles[keys[0]].filepath
    img = read_image(first)
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 65535, img.shape, dtype=np.uint16)
    assert cv2.imwrite(first, noise,
                       [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])

    cname, _, _ = pipe.resolved_compressor()
    assert cname == 'lz4'  # median of {noisy, clean, clean} -> compress

    # an all-noise plate still picks raw
    for key in keys:
        path = pipe.acq.tiles[key].filepath
        shp = read_image(path).shape
        assert cv2.imwrite(path, rng.integers(0, 65535, shp,
                                              dtype=np.uint16),
                           [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])
    pipe._compressor_choice = None
    assert pipe.resolved_compressor()[0] is None


def test_parallel_merge_units_match_sequential(tmp_path, monkeypatch):
    """Merge units (regions/wells) are independent; forced onto a
    multi-worker pool they must produce the same trees a sequential run
    does (r3: _map_merge_units + atomic group-metadata writes — shared
    plate-row metadata is written by several wells concurrently)."""
    import numpy as np
    import tensorstore as ts
    from fixtures import write_synthetic_acquisition
    from image_stitcher_tpu import EngineOptions, StitchingParameters
    from image_stitcher_tpu.models.pipeline import StitchPipeline

    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                tile_w=96, tile_h=96, overlap=16,
                                timepoints=2,
                                regions=["A1", "A2", "B1", "B2"])
    results = {}
    for label, cpus in (("seq", 1), ("par", 4)):
        # merge.py resolves _available_cpus from params at call time,
        # so the params patch is the one that steers the pool size
        import image_stitcher_tpu.params as params_mod
        monkeypatch.setattr(params_mod, "_available_cpus", lambda n=cpus: n)
        p = StitchingParameters(input_folder=acq_dir,
                                merge_timepoints=True,
                                merge_hcs_regions=True)
        pipe = StitchPipeline(p, EngineOptions(
            output_folder=str(tmp_path / label)))
        pipe.run()
        plate = str(tmp_path / label / "hcs_timepoints" /
                    "complete_hcs.ome.zarr")
        wells = {}
        for region in ("A1", "A2", "B1", "B2"):
            zp = f"{plate}/{region[0]}/{region[1:]}/0/0"
            wells[region] = np.asarray(ts.open(
                {"driver": "zarr",
                 "kvstore": {"driver": "file", "path": zp}}).result()
                .read().result())
        results[label] = wells
    for region in results["seq"]:
        assert (results["seq"][region] == results["par"][region]).all()
