import numpy as np
import pytest

from image_stitcher_tpu.io.acquisition import (
    scan_acquisition, scan_timepoints, parse_tile_filename, compute_pixel_size,
    read_image)
from image_stitcher_tpu.utils.colors import get_channel_color

from fixtures import write_synthetic_acquisition, DEFAULT_ACQ_PARAMS


def test_parse_tile_filename():
    assert parse_tile_filename("A1_3_0_Fluorescence_488_nm_Ex.tiff") == \
        ("A1", 3, 0, "Fluorescence 488 nm Ex")
    assert parse_tile_filename("B2_0_1_BF_LED_matrix_full.bmp") == \
        ("B2", 0, 1, "BF LED matrix full")
    # focus camera + hidden + non-image files skipped
    assert parse_tile_filename("A1_0_0_focus_camera.bmp") is None
    assert parse_tile_filename(".hidden_1_2_x.tiff") is None
    assert parse_tile_filename("coordinates.csv") is None
    # 'full ' prefix restored to 'full_' (reference stitcher.py:174)
    assert parse_tile_filename("A1_0_0_full_0.tiff") == ("A1", 0, 0, "full_0")


def test_pixel_size_math():
    ps, binning = compute_pixel_size(DEFAULT_ACQ_PARAMS)
    # 10.0 um sensor / (180 / (180/10)) = 1.0
    assert ps == pytest.approx(1.0)
    assert binning == 1
    params = dict(DEFAULT_ACQ_PARAMS)
    params["pixel_binning"] = 2
    assert compute_pixel_size(params)[1] == 2


def test_channel_colors():
    assert get_channel_color("Fluorescence 405 nm Ex") == 0x0000FF
    assert get_channel_color("Fluorescence 488 nm Ex") == 0x00FF00
    assert get_channel_color("Fluorescence 561 nm Ex") == 0xFFCF00
    assert get_channel_color("Fluorescence 638 nm Ex") == 0xFF0000
    assert get_channel_color("Fluorescence 730 nm Ex") == 0x770000
    assert get_channel_color("BF_R") == 0xFF0000
    assert get_channel_color("BF LED matrix full") == 0xFFFFFF


def test_scan_acquisition_basic(tmp_path):
    acq_desc = write_synthetic_acquisition(
        str(tmp_path / "acq"), grid_cols=2, grid_rows=2, tile_w=64, tile_h=48,
        overlap=16, channels=["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"],
        timepoints=2, num_z=2)
    acq = scan_acquisition(str(tmp_path / "acq"))
    assert acq.timepoints == ["0", "1"]
    assert acq.num_t == 2
    assert acq.num_z == 2
    assert acq.regions == ["A1"]
    assert acq.channel_names == ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"]
    assert acq.monochrome_channels == acq.channel_names  # no RGB expansion
    assert acq.num_c == 2
    assert acq.num_fovs_per_region == 4
    assert (acq.input_height, acq.input_width) == (48, 64)
    assert acq.dtype == np.uint16
    assert acq.pixel_size_um == pytest.approx(1.0)
    # 2 t * 1 region * 4 fov * 2 z * 2 ch tiles
    assert len(acq.tiles) == 2 * 4 * 2 * 2
    key = (0, "A1", 0, 0, "Fluorescence 488 nm Ex")
    assert key in acq.tiles
    rec = acq.tiles[key]
    assert rec.x == 0.0 and rec.y == 0.0
    xs, ys = acq.region_positions(0, "A1")
    assert len(xs) == 2 and len(ys) == 2
    # step = (64-16) px * 1um/px / 1000 = 0.048 mm
    assert xs[1] - xs[0] == pytest.approx(0.048)


def test_scan_timepoints_sorts_numerically(tmp_path):
    for d in ["0", "2", "10", "notes"]:
        (tmp_path / d).mkdir()
    assert scan_timepoints(str(tmp_path)) == ["0", "2", "10"]


def test_region_tiles_missing_raises(tmp_path):
    write_synthetic_acquisition(str(tmp_path / "acq"), grid_cols=1, grid_rows=1,
                                tile_w=32, tile_h=32, overlap=8)
    acq = scan_acquisition(str(tmp_path / "acq"))
    with pytest.raises(ValueError):
        acq.region_tiles(0, "Z9")


def test_find_tile(tmp_path):
    write_synthetic_acquisition(str(tmp_path / "acq"), grid_cols=2, grid_rows=1,
                                tile_w=32, tile_h=32, overlap=8)
    acq = scan_acquisition(str(tmp_path / "acq"))
    xs, ys = acq.region_positions(0, "A1")
    rec = acq.find_tile(0, "A1", xs[1], ys[0], acq.channel_names[0], 0)
    assert rec is not None and rec.fov_idx == 1
    assert acq.find_tile(0, "A1", 99.0, 0.0, acq.channel_names[0], 0) is None


def test_read_image_round_trip(tmp_path):
    import cv2
    img = (np.random.default_rng(0).random((16, 20)) * 65535).astype(np.uint16)
    p = str(tmp_path / "x.tiff")
    cv2.imwrite(p, img)
    back = read_image(p)
    np.testing.assert_array_equal(back, img)


def test_rgb_expansion(tmp_path):
    import cv2
    # Write an RGB acquisition by hand
    folder = tmp_path / "rgb"
    (folder / "0").mkdir(parents=True)
    import json
    with open(folder / "acquisition parameters.json", "w") as f:
        json.dump(DEFAULT_ACQ_PARAMS, f)
    rgb = (np.random.default_rng(1).random((8, 8, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(folder / "0" / "A1_0_0_BF_LED_matrix_full.png"), rgb[:, :, ::-1])
    import pandas as pd
    pd.DataFrame([{"region": "A1", "fov": 0, "z_level": 0,
                   "x (mm)": 0.0, "y (mm)": 0.0, "z (um)": 0.0}]).to_csv(
        folder / "0" / "coordinates.csv", index=False)
    acq = scan_acquisition(str(folder))
    # base = channel.split('_')[0]; munging already turned underscores into
    # spaces, so the whole name survives (reference stitcher.py:174,243)
    assert acq.monochrome_channels == [
        "BF LED matrix full_R", "BF LED matrix full_G", "BF LED matrix full_B"]
    assert acq.monochrome_colors == [0xFF0000, 0x00FF00, 0x0000FF]
    assert acq.rgb_channels == ["BF LED matrix full"]


def test_numeric_region_names_match_coordinates(tmp_path):
    """Purely-numeric region names ('0', '12'): pandas reads the CSV
    column as int64, but filenames parse to str — the join must compare
    as strings or every tile is silently skipped."""
    from image_stitcher_tpu import scan_acquisition
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=48, tile_h=48, overlap=16,
                                regions=["0", "7"])
    acq = scan_acquisition(acq_dir)
    assert sorted(acq.regions) == ["0", "7"]
    assert len(acq.tiles) == 4


def test_numeric_regions_survive_float_coercion(tmp_path):
    """One blank region cell coerces pandas' region column to float64 —
    '5' would str() as '5.0' and never match the filename-parsed name.
    Integral floats must render as ints; the corrupt row itself is
    skipped (NaN region), everything else still joins."""
    import glob
    import os

    import pandas as pd

    from image_stitcher_tpu import scan_acquisition
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=48, tile_h=48, overlap=16,
                                regions=["5", "7"])
    csv = glob.glob(os.path.join(acq_dir, "*", "coordinates.csv"))[0]
    df = pd.read_csv(csv)
    # corrupt one row's region: the whole column becomes float64
    blank = df.iloc[[0]].copy()
    blank["region"] = float("nan")
    blank["fov"] = 99
    pd.concat([df, blank]).to_csv(csv, index=False)
    assert pd.read_csv(csv)["region"].dtype == "float64"

    acq = scan_acquisition(acq_dir)
    assert sorted(acq.regions) == ["5", "7"]
    assert len(acq.tiles) == 4


def test_find_tile_float_perturbed_coords(tmp_path):
    """Keys are quantized to 0.1 um: a coordinate that round-tripped
    through JSON with its last ulp perturbed must still hit the index
    (VERDICT r4 hardening)."""
    import json
    write_synthetic_acquisition(str(tmp_path / "acq"), grid_cols=2,
                                grid_rows=1, tile_w=32, tile_h=32, overlap=8)
    acq = scan_acquisition(str(tmp_path / "acq"))
    xs, ys = acq.region_positions(0, "A1")
    # simulate a float round-trip: 17 sig figs + tiny perturbation well
    # under the 0.1 um quantum (coords are in mm; 1e-6 mm = 1 nm)
    x = float(json.loads(json.dumps(xs[1]))) + 1e-6
    y = ys[0] - 1e-6
    rec = acq.find_tile(0, "A1", x, y, acq.channel_names[0], 0)
    assert rec is not None and rec.fov_idx == 1
    # but a genuinely different position (>= one tile pitch away) misses
    assert acq.find_tile(0, "A1", xs[1] + 0.01, ys[0],
                         acq.channel_names[0], 0) is None


# ------------------------------------------------ coordinates.csv (stdlib)

@pytest.mark.parametrize("row,expect", [
    ("A1,,0,1.0,2.0,0.0", None),            # blank fov
    ("A1,1.5,0,1.0,2.0,0.0", None),         # fractional fov
    ("A1,1,nan,1.0,2.0,0.0", None),         # NaN z_level
    (",1,0,1.0,2.0,0.0", None),             # blank region
    ("5.0,1,0,1.0,2.0,0.0", ("5", 1, 0)),   # float-typed numeric region
    ("A1,0,0,9.0,9.0,0.0", ("A1", 0, 0)),   # duplicate: first row wins
], ids=["blank-fov", "fractional-fov", "nan-z", "blank-region",
        "numeric-region", "first-wins"])
def test_read_coordinates_skip_rules(tmp_path, row, expect):
    from image_stitcher_tpu.io.acquisition import read_coordinates
    path = tmp_path / "coordinates.csv"
    path.write_text("region,fov,z_level,x (mm),y (mm),z (um)\n"
                    "A1,0,0,0.5,0.25,0.0\n" + row + "\n")
    rows = read_coordinates(str(path))
    assert rows[("A1", 0, 0)]["x (mm)"] == "0.5"
    assert set(rows) - {("A1", 0, 0)} == (
        set() if expect is None or expect == ("A1", 0, 0) else {expect})
