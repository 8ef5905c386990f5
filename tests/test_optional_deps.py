"""The main path needs only JAX, NumPy, SciPy and the standard library.

tensorstore (Blosc / zarr v3 / reading stores back), OpenCV (non-TIFF
tiles, subpixel warping, JPEG OME-TIFF) and pandas (coordinate tools) are
optional: blocked in ``sys.modules``, the package still imports and a
raw-zarr stitch still runs, and each optional feature fails with a clear
message.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = ("tensorstore", "pandas", "cv2", "PIL", "imageio")
PRELUDE = ("import sys\n"
           f"for m in {BLOCK!r}:\n"
           "    sys.modules[m] = None\n"
           f"sys.path.insert(0, {REPO!r})\n")


def _run_blocked(code, tmp_path):
    out = subprocess.run([sys.executable, '-c', PRELUDE + code],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def test_import_without_optional_packages(tmp_path):
    out = _run_blocked(
        "import image_stitcher_tpu\n"
        "from image_stitcher_tpu.io import acquisition, omezarr, zarr_store\n"
        "from image_stitcher_tpu.models import merge, pipeline\n"
        "print('blocked-ok', zarr_store.have_tensorstore())\n", tmp_path)
    assert 'blocked-ok False' in out


@pytest.mark.parametrize("blend", ["overwrite", "feather"])
def test_raw_zarr_stitch_without_optional_packages(tmp_path, blend):
    """Registration + flatfield + raw zarr v2, device path (the XLA scan
    on the CPU backend), read back chunk by chunk with NumPy."""
    out = _run_blocked(
        "import json, chip_smoke\n"
        "from image_stitcher_tpu import EngineOptions, stitch\n"
        "chip_smoke.write_acquisition('acq', 3, 96, 12, 2, seed=1)\n"
        "pipe = stitch('acq', use_registration=True, apply_flatfield=True,\n"
        "              options=EngineOptions(compressor_cname=None,\n"
        f"                  fusion_device='device', blend_method={blend!r},\n"
        "                  streaming='on', output_folder='out'))\n"
        "lv = chip_smoke.read_level(chip_smoke.region_store(pipe), 0)\n"
        "print(json.dumps({'shape': list(lv.shape), 'max': int(lv.max())}))\n",
        tmp_path)
    res = json.loads(out.strip().splitlines()[-1])
    assert res['shape'][:3] == [1, 3, 1] and min(res['shape'][3:]) > 200
    assert res['max'] > 0


@pytest.mark.parametrize("kw", [dict(), dict(compressor_cname='zstd'),
                                dict(compressor_cname=None, zarr_format=3)])
def test_blosc_or_v3_without_tensorstore_fails_validate(monkeypatch, kw):
    from image_stitcher_tpu import EngineOptions
    from image_stitcher_tpu.io import zarr_store
    monkeypatch.setattr(zarr_store, 'have_tensorstore', lambda: False)
    with pytest.raises(ValueError, match="tensorstore"):
        EngineOptions(**kw).validate()


def test_raw_v2_without_tensorstore_validates(monkeypatch):
    from image_stitcher_tpu import EngineOptions
    from image_stitcher_tpu.io import zarr_store
    monkeypatch.setattr(zarr_store, 'have_tensorstore', lambda: False)
    EngineOptions(compressor_cname=None).validate()


def test_compressor_auto_without_tensorstore_stores_raw(tmp_path,
                                                        monkeypatch):
    """'auto' decides: without tensorstore the only choice is raw."""
    from image_stitcher_tpu import EngineOptions, StitchingParameters
    from image_stitcher_tpu.io import zarr_store
    from image_stitcher_tpu.models.pipeline import StitchPipeline
    from image_stitcher_tpu.utils.progress import ProgressReporter
    monkeypatch.setattr(zarr_store, 'have_tensorstore', lambda: False)
    status = []
    opts = EngineOptions(compressor_cname='auto')
    opts.validate()
    pipe = StitchPipeline(
        StitchingParameters(input_folder=str(tmp_path)), opts,
        ProgressReporter(status=lambda msg, saving=False: status.append(msg)))
    assert pipe.resolved_compressor() == (None, 0, 0)
    assert any("tensorstore not installed" in s for s in status)


def _read_png(tmp_path):
    from image_stitcher_tpu.io.acquisition import read_image
    path = tmp_path / "tile.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    read_image(str(path))


def _warp(tmp_path):
    import chip_smoke
    from image_stitcher_tpu.io.readers import TileJob, load_tile_plane
    path = str(tmp_path / "tile.tiff")
    chip_smoke.write_tiff(path, np.zeros((8, 8), np.uint16))
    load_tile_plane(TileJob(filepath=path, plane=-1, channel_idx=0,
                            z_level=0, y=0, x=0, crops=(0, 0, 0, 0),
                            fy=0.25, fx=0.5))


def _jpeg(tmp_path):
    from image_stitcher_tpu.io.tiffwriter import _encode_jpeg
    _encode_jpeg(np.zeros((16, 16), np.uint8), 85)


@pytest.mark.parametrize("call", [_read_png, _warp, _jpeg],
                         ids=["non-tiff tile", "subpixel warp", "jpeg tiff"])
def test_cv2_features_raise_clear_import_error(tmp_path, monkeypatch, call):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match="OpenCV"):
        call(tmp_path)


def test_raw_writer_without_native_kernel_matches(tmp_path, monkeypatch):
    """Without the C kernel the raw v2 writer writes the same bytes with
    NumPy and os.pwrite."""
    import chip_smoke
    from image_stitcher_tpu.io import raw_zarr
    from image_stitcher_tpu.io.zarr_store import create_raw_zarr_array
    rng = np.random.default_rng(3)
    shape, chunks = (1, 2, 1, 150, 130), (1, 1, 1, 64, 64)
    data = rng.integers(0, 65535, shape, np.uint16)
    files = {}
    for name, lib in (("native", raw_zarr.get_lib()), ("numpy", None)):
        monkeypatch.setattr(raw_zarr, 'get_lib', lambda lib=lib: lib)
        path = str(tmp_path / name / "0")
        create_raw_zarr_array(path, shape, chunks, np.uint16)
        w = raw_zarr.RawV2SlabWriter(path, shape, chunks, np.uint16,
                                     direct_io='off')
        for y0 in (0, 50, 100):
            sel = (slice(0, 1), slice(None), slice(None),
                   slice(y0, y0 + 50), slice(0, 130))
            assert w.try_write(sel, data[..., y0:y0 + 50, :])
        files[name] = {os.path.relpath(os.path.join(d, f), path):
                       open(os.path.join(d, f), 'rb').read()
                       for d, _, fs in os.walk(path) for f in fs}
    assert files["native"] == files["numpy"]
    np.testing.assert_array_equal(
        chip_smoke.read_level(str(tmp_path / "numpy"), 0), data)


def test_raw_zarray_matches_tensorstore(tmp_path):
    """The .zarray written without tensorstore is the one tensorstore
    writes for the same raw array."""
    from image_stitcher_tpu.io.zarr_store import (create_raw_zarr_array,
                                                  create_zarr_array)
    for dtype in (np.uint16, np.uint8):
        shape, chunks = (1, 3, 1, 300, 500), (1, 1, 1, 128, 1024)
        a, b = str(tmp_path / "ts"), str(tmp_path / "raw")
        create_zarr_array(a, shape, chunks, dtype, cname=None)
        create_raw_zarr_array(b, shape, chunks, dtype)
        assert (json.load(open(os.path.join(a, ".zarray")))
                == json.load(open(os.path.join(b, ".zarray"))))
