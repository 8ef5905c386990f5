"""chip_smoke.py on the CPU: its fixture writer, its refusals, and the
``--rehearse`` run end to end."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fixture_tiff_reads_back_on_the_fast_path(tmp_path):
    from image_stitcher_tpu.io.fast_tiff import read_tiff_fast
    img = np.random.default_rng(0).integers(0, 65535, (37, 53), np.uint16)
    path = str(tmp_path / "t.tiff")
    chip_smoke.write_tiff(path, img)
    for mmap in (False, True):
        np.testing.assert_array_equal(read_tiff_fast(path, use_mmap=mmap),
                                      img)


def test_fixture_acquisition_scans(tmp_path):
    """The generated acquisition is a valid Squid folder: every tile is
    indexed at its ideal stage position, and tiles are the vignetted
    ground truth."""
    from image_stitcher_tpu.io.acquisition import scan_acquisition
    gt = chip_smoke.write_acquisition(str(tmp_path), 3, 64, 8, 2, seed=5)
    acq = scan_acquisition(str(tmp_path))
    assert len(acq.tiles) == 3 * 3 * 3
    assert (acq.input_height, acq.input_width) == (64, 64)
    assert acq.channel_names == sorted(chip_smoke.CHANNELS)
    assert acq.pixel_size_um == 1.0 and acq.pixel_binning == 2
    xs, ys = acq.region_positions(0, "A1")
    np.testing.assert_allclose(np.diff(xs), 0.056)
    np.testing.assert_allclose(np.diff(ys), 0.056)
    assert gt.dtype == np.float32 and gt.min() >= 0 and gt.max() < 1


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env.update(JAX_PLATFORMS='cpu', **(env_extra or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_smoke_refuses_cpu_without_rehearse(tmp_path):
    out = _run([os.path.join(REPO, "chip_smoke.py")], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script fails and prints no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py", "--rehearse"], str(tmp_path),
               {'PYTHONPATH': ''})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_rehearse_end_to_end(tmp_path):
    """Both stitches, every parity phase, the precision phase and the
    gpu-marked tests (skipped here) pass; the last line is the result."""
    out = _run([os.path.join(REPO, "chip_smoke.py"), "--rehearse"],
               str(tmp_path))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 1}}
    for phase in ("(a) host reference + overwrite byte parity",
                  "(b) registered shifts vs the f64 twin",
                  "(b) device flatfields vs the host fit",
                  "(b) host reference + feather parity",
                  "phasecorr precision: HIGHEST vs DEFAULT"):
        assert f"ok: {phase}" in out.stdout
    assert "FAILED" not in out.stdout
