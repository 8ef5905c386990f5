import os
import time

import numpy as np
import pandas as pd
import pytest


def test_update_coordinates_get_image_info():
    from image_stitcher_tpu.tools.update_coordinates import get_image_info
    info = get_image_info("B2_5_0_Fluorescence_488_nm_Ex.tiff")
    assert info == {'region': 'B2', 'fov': '5', 'z_level': 0}
    with pytest.raises(ValueError):
        get_image_info("nounderscores.tiff")


def test_update_coordinates_process_folder(tmp_path):
    from image_stitcher_tpu.tools.update_coordinates import process_folder
    import cv2
    folder = tmp_path / "0"
    folder.mkdir()
    img = np.zeros((4, 4), np.uint16)
    # old-format files; mtimes define order
    f1 = folder / "A1_0_0_405.tiff"
    f2 = folder / "A1_1_0_405.tiff"
    cv2.imwrite(str(f1), img)
    cv2.imwrite(str(f2), img)
    now = time.time()
    os.utime(f1, (now - 100, now - 100))
    os.utime(f2, (now - 50, now - 50))
    pd.DataFrame({
        "z_level": [0, 0], "x (mm)": [1.0, 2.0], "y (mm)": [3.0, 4.0],
        "z (um)": [0.0, 0.0], "time": ["t1", "t2"],
    }).to_csv(folder / "coordinates.csv", index=False)
    df = process_folder(str(folder))
    assert list(df.columns) == ["region", "fov", "z_level", "x (mm)",
                                "y (mm)", "z (um)", "time"]
    assert list(df["fov"]) == ["0", "1"]  # mtime order
    assert list(df["region"]) == ["A1", "A1"]


def test_convert_to_coordinate_acquisition(tmp_path):
    from image_stitcher_tpu.tools.convert_to_coordinate_acquisition import convert
    import cv2
    acq = tmp_path / "acq"
    sub = acq / "0"
    sub.mkdir(parents=True)
    img = (np.ones((4, 4)) * 7).astype(np.uint16)
    rows = []
    for i in range(2):
        for j in range(3):
            cv2.imwrite(str(sub / f"X_{i}_{j}_0_405.tiff"), img)
            rows.append({"i": i, "j": j, "z_level": 0,
                         "x (mm)": j * 0.1, "y (mm)": i * 0.1, "z (um)": 0.0})
    pd.DataFrame(rows).to_csv(sub / "coordinates.csv", index=False)
    total = convert(str(acq), region="C4")
    assert total == 6
    df = pd.read_csv(sub / "coordinates.csv")
    assert list(df.columns)[:3] == ["region", "fov", "z_level"]
    # fov = i * max_j + j with max_j = 3
    assert sorted(df["fov"]) == [0, 1, 2, 3, 4, 5]
    assert (df["region"] == "C4").all()
    assert (sub / "C4_4_0_405.tiff").exists()  # i=1,j=1 -> fov 4
    assert (acq.parent / "acq_old" / "0" / "X_1_1_0_405.tiff").exists()


def test_ashlar_export(tmp_path):
    from image_stitcher_tpu.tools.ashlar_export import (AshlarConverter,
                                                        build_ashlar_command)
    from fixtures import write_synthetic_acquisition
    from PIL import Image
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                tile_w=64, tile_h=48, overlap=16)
    conv = AshlarConverter(acq_dir)
    out_dir = conv.run(str(tmp_path / "export"))
    files = sorted(os.listdir(out_dir))
    assert len(files) == 4
    # tile readable + carries plate XML
    img = Image.open(os.path.join(out_dir, files[0]))
    arr = np.asarray(img)
    assert arr.shape == (48, 64)
    desc = img.tag_v2[270]
    assert '<Plate' in desc and 'PositionX' in desc
    cmd = build_ashlar_command(conv, files, "out.ome.tif")
    assert cmd[0] == 'ashlar'
    assert '--tile-size' in cmd and cmd[cmd.index('--tile-size') + 1] == '64'
    assert '--maximum-shift' in cmd
    cmd2 = build_ashlar_command(conv, files, "o", no_alignment=True)
    assert '--maximum-shift' not in cmd2


def test_convert_refuses_rerun_and_keeps_backup(tmp_path):
    """A second conversion must neither delete the backup of the
    original data nor proceed on already-converted coordinates."""
    from image_stitcher_tpu.tools.convert_to_coordinate_acquisition import \
        convert
    import cv2
    acq = tmp_path / "acq"
    sub = acq / "0"
    sub.mkdir(parents=True)
    img = (np.ones((4, 4)) * 7).astype(np.uint16)
    rows = []
    for i in range(1):
        for j in range(2):
            cv2.imwrite(str(sub / f"X_{i}_{j}_0_405.tiff"), img)
            rows.append({"i": i, "j": j, "z_level": 0,
                         "x (mm)": j * 0.1, "y (mm)": 0.0, "z (um)": 0.0})
    pd.DataFrame(rows).to_csv(sub / "coordinates.csv", index=False)
    convert(str(acq), region="C4")
    backup = tmp_path / "acq_old"
    assert (backup / "0" / "X_0_0_0_405.tiff").exists()
    with pytest.raises(ValueError, match="already converted"):
        convert(str(acq), region="C4")
    # the run-1 backup (only copy of original data) is untouched
    assert (backup / "0" / "X_0_0_0_405.tiff").exists()


def test_convert_stride_spans_timepoints(tmp_path):
    """Truncated timepoints must not renumber tiles: one fov stride for
    the whole acquisition."""
    from image_stitcher_tpu.tools.convert_to_coordinate_acquisition import \
        convert
    import cv2
    acq = tmp_path / "acq"
    img = (np.ones((4, 4)) * 7).astype(np.uint16)
    for t, n_j in (("0", 3), ("1", 2)):   # t1 truncated mid-row
        sub = acq / t
        sub.mkdir(parents=True)
        rows = []
        for j in range(n_j):
            cv2.imwrite(str(sub / f"X_0_{j}_0_405.tiff"), img)
            cv2.imwrite(str(sub / f"X_1_{j}_0_405.tiff"), img)
            rows.append({"i": 0, "j": j, "z_level": 0,
                         "x (mm)": j * 0.1, "y (mm)": 0.0, "z (um)": 0.0})
            rows.append({"i": 1, "j": j, "z_level": 0,
                         "x (mm)": j * 0.1, "y (mm)": 0.1, "z (um)": 0.0})
        pd.DataFrame(rows).to_csv(sub / "coordinates.csv", index=False)
    convert(str(acq), region="C4")
    # row i=1 starts at fov 3 (the FULL grid's stride) in BOTH timepoints
    for t in ("0", "1"):
        df = pd.read_csv(acq / t / "coordinates.csv")
        assert set(df[df["y (mm)"] == 0.1]["fov"]) <= {3, 4, 5}
        assert (acq / t / "C4_3_0_405.tiff").exists()


def test_update_coordinates_refuses_count_mismatch(tmp_path):
    """Row/image count mismatch would silently shift coordinates; the
    tool must refuse instead of rewriting a corrupted csv."""
    from image_stitcher_tpu.tools.update_coordinates import process_folder
    import cv2
    folder = tmp_path / "0"
    folder.mkdir()
    img = np.zeros((4, 4), np.uint16)
    cv2.imwrite(str(folder / "A1_0_0_405.tiff"), img)
    pd.DataFrame({
        "z_level": [0, 0], "x (mm)": [1.0, 2.0], "y (mm)": [3.0, 4.0],
        "z (um)": [0.0, 0.0], "time": ["t1", "t2"],
    }).to_csv(folder / "coordinates.csv", index=False)
    before = (folder / "coordinates.csv").read_text()
    with pytest.raises(ValueError, match="counts"):
        process_folder(str(folder))
    assert (folder / "coordinates.csv").read_text() == before


def test_ashlar_export_timepoint_prefix(tmp_path):
    """Reference naming (ashlar_stitcher.py:238): multi-timepoint tiles
    must not clobber each other."""
    import glob

    from fixtures import write_synthetic_acquisition
    from image_stitcher_tpu.tools.ashlar_export import AshlarConverter
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=1,
                                tile_w=32, tile_h=32, overlap=8,
                                timepoints=2)
    conv = AshlarConverter(acq_dir)
    out = conv.run(str(tmp_path / "export"))
    files = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(out, "*.ome.tif")))
    assert len(files) == 4  # 2 tiles x 2 timepoints, no clobbering
    assert files[0].startswith("000_A1_000_000_")
    assert files[-1].startswith("001_A1_001_000_")


def test_doctor_reports_all_sections(tmp_path, capsys):
    """stitcher-doctor prints every section and names the device the
    way results are labelled (platform, kind, count)."""
    from image_stitcher_tpu.tools import doctor
    rc = doctor.main(['--output-dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    for section in ('[Device]', '[Native]', '[Disk]', '[Caches]'):
        assert section in out
    assert 'platform=cpu' in out and 'count=' in out
    assert 'disk write' in out
    assert 'jax compile cache' in out


def test_doctor_cpu_backend_reports_host(tmp_path, capsys):
    """On the CPU backend 'auto' fusion is the host canvas (on a GPU it
    is the device); no child process, no probe."""
    from image_stitcher_tpu.tools import doctor
    rc = doctor.main(['--output-dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fusion_device='auto' runs fusion on: host" in out
