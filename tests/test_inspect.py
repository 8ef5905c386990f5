import glob
import os

import numpy as np

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu import stitch
from image_stitcher_tpu.utils.inspect import (format_zarr_tree,
                                              save_debug_slice, zarr_tree)


def test_zarr_tree_and_debug_slice(tmp_path, capsys):
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=48, tile_h=48, overlap=16)
    stitch(acq_dir)
    out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
    zp = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr")

    tree = zarr_tree(zp)
    assert "attrs" in tree and "multiscales" in tree["attrs"]
    assert "0" in tree["children"]
    assert tree["children"]["0"]["array"]["dtype"] == "<u2"
    assert tree["children"]["0"]["array"]["compressor"] == "blosc"

    text = format_zarr_tree(zp)
    assert "A1_stitched.ome.zarr" in text
    assert "<u2" in text and "multiscales" in text

    from image_stitcher_tpu.utils.inspect import print_zarr_structure
    print_zarr_structure(zp)
    assert "Zarr tree" in capsys.readouterr().out


def test_save_debug_slice(tmp_path):
    canvas = np.zeros((2, 1, 32, 40), np.uint16)
    canvas[0, 0, :16] = 40000
    canvas[1, 0, :, :20] = 20000
    out = save_debug_slice(canvas, str(tmp_path / "dbg.png"))
    assert out and os.path.exists(out)
    import cv2
    img = cv2.imread(out)
    assert img.shape == (32, 40, 3)
    # channel 0 -> R plane (BGR index 2) bright in top half
    assert img[8, 8, 2] == 255 and img[24, 8, 2] == 0


def test_stitch_device_fusion_matches_numpy_reference(tmp_path):
    """A coordinate stitch through the device fusion path (the XLA scan)
    equals the tiles slice-assigned by NumPy at their stage positions —
    here the ground-truth window they were cut from."""
    from image_stitcher_tpu.params import EngineOptions
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    acq_dir = str(tmp_path / "acq")
    syn = write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=2,
                                      tile_w=48, tile_h=40, overlap=12)
    stitch(acq_dir, options=EngineOptions(fusion_device='device',
                                          fusion_batch=4))
    out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
    zp = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr", "0")
    got = np.asarray(open_zarr_array(zp).read().result())[0, 0, 0]
    expect = np.zeros_like(got)
    for (_, _, r, c), (y0, x0) in sorted(syn.tile_origins.items()):
        y, x = r * (40 - 12), c * (48 - 12)
        expect[y:y + 40, x:x + 48] = syn.ground_truth[y0:y0 + 40,
                                                      x0:x0 + 48]
    np.testing.assert_array_equal(got, expect)


def test_zarr_tree_v3(tmp_path, capsys):
    """The inspector walks zarr v3 trees: group attrs from zarr.json,
    sharding_indexed arrays reported by their READ chunk + codec."""
    from image_stitcher_tpu import EngineOptions
    from image_stitcher_tpu.utils.inspect import main as inspect_main
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=48, tile_h=48, overlap=16)
    stitch(acq_dir, options=EngineOptions(zarr_format=3,
                                          chunks=(1, 1, 1, 32, 32)))
    out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
    zp = os.path.join(out, "0_stitched", "A1_stitched.ome.zarr")

    tree = zarr_tree(zp)
    assert "ome" in tree["attrs"]  # NGFF 0.5 attrs live under 'ome'
    arr = tree["children"]["0"]["array"]
    assert arr["dtype"] == "uint16"
    assert arr["chunks"][-2:] == [32, 32]  # read chunk, not the shard
    assert arr["compressor"] == "blosc"

    assert inspect_main([zp]) == 0
    assert "uint16" in capsys.readouterr().out
    assert inspect_main([zp, "--json"]) == 0
    assert '"shape"' in capsys.readouterr().out


def test_compare_stores_identical_and_perturbed(tmp_path, capsys):
    """--compare: two runs of the same acquisition (one v2, one
    v3-sharded) compare pixel-identical across zarr versions; flipping
    one chunk byte then reports a difference and exit code 1."""
    from image_stitcher_tpu import EngineOptions, stitch
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    from image_stitcher_tpu.utils.inspect import (compare_stores,
                                                  main as inspect_main)

    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                tile_w=48, tile_h=48, overlap=16)

    def run(fmt):
        stitch(acq_dir, options=EngineOptions(zarr_format=fmt,
                                              chunks=(1, 1, 1, 32, 32)))
        out = sorted(glob.glob(acq_dir + "_stitched_*"))[-1]
        return os.path.join(out, "0_stitched", "A1_stitched.ome.zarr")

    zp2 = run(2)
    zp3 = run(3)
    assert zp2 != zp3  # timestamped folders differ

    rep = compare_stores(zp2, zp3, band_rows=16)
    assert rep['equal'], rep
    assert all(r['mismatched'] == 0 for r in rep['arrays'].values())
    assert inspect_main([zp2, "--compare", zp3]) == 0
    assert "identical" in capsys.readouterr().out

    # perturb one pixel of level 0 in the v2 store
    arr = open_zarr_array(os.path.join(zp2, "0"), writable=True)
    v = arr[0, 0, 0, 5, 5].read().result()
    arr[0, 0, 0, 5, 5].write(v + 1).result()
    rep = compare_stores(zp2, zp3, band_rows=16)
    assert not rep['equal']
    assert rep['arrays']['0']['mismatched'] == 1
    assert rep['arrays']['0']['maxdiff'] == 1.0
    assert inspect_main([zp2, "--compare", zp3]) == 1
