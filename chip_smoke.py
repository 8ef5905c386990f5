#!/usr/bin/env python3
"""GPU smoke test: the W1 stitch end to end on the card, checked against
the host path.

W1 is the headline acquisition: 10x10 tiles, 3 channels, 2048^2 uint16,
~10% overlap, with flatfield and registration (2.4 GB of tiles, a
3 x ~18.6k^2 canvas). The fixture is generated from ``--seed`` with NumPy
into a temporary directory and stitched through the public
``image_stitcher_tpu.stitch`` twice:

(a) quick-start settings (registration + flatfield, default options):
    fusion and pyramid run on the device by band streaming;
(b) max-quality settings (global registration, feather blending, device
    flatfield): batched phase correlation, the ADMM fit and the f32
    feather accumulators run on the card.

Each run is compared with the host path on the same fixture, fed the
same flatfields and positions through the run manifest (``resume``):
overwrite output byte-identical, feather within 1 LSB, registered pair
shifts within 0.1 px of the f64 twin, fitted flatfields within 2e-2.
Output is raw OME-Zarr v2, compared chunk file by chunk file.

Usage::

    python chip_smoke.py                # one GPU, the W1 workload
    python chip_smoke.py --four-cards   # mesh (1, 4) against one card only
    python chip_smoke.py --rehearse     # tiny grid; the CPU is allowed

Without a GPU (and without ``--rehearse``) it exits non-zero before any
work. Any failed phase makes it exit non-zero without the result line.
The last line of a passing run is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex",
            "Fluorescence 561 nm Ex"]
ACQ_PARAMS = {
    "dx(mm)": 0.1, "dy(mm)": 0.1, "dz(um)": 1.5,
    "objective": {"magnification": 10, "tube_lens_f_mm": 180,
                  "name": "10x"},
    "sensor_pixel_size_um": 10.0, "tube_lens_mm": 180,
    # 1.0 um/px; binning 2 makes the registration strips the full overlap
    "pixel_binning": 2,
}
# (grid, tile, overlap, jitter): W1, and the rehearsal's tiny stand-in
FULL = (10, 2048, 205, 3)
REHEARSAL = (3, 128, 16, 2)
SHIFT_TOL_PX = 0.1
FLATFIELD_TOL = 2e-2
FEATHER_TOL_LSB = 1


# ------------------------------------------------------------------ fixture

def write_tiff(path: str, img: np.ndarray) -> None:
    """Uncompressed single-strip little-endian TIFF (the Squid camera
    format io/fast_tiff.py reads on its fast path)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape
    data_off = 8
    ifd_off = data_off + img.nbytes
    entries = [  # (tag, type, count, value); type 3 = SHORT, 4 = LONG
        (256, 4, 1, w), (257, 4, 1, h),
        (258, 3, 1, img.dtype.itemsize * 8), (259, 3, 1, 1),
        (262, 3, 1, 1), (273, 4, 1, data_off), (277, 3, 1, 1),
        (278, 4, 1, h), (279, 4, 1, img.nbytes), (339, 3, 1, 1)]
    ifd = struct.pack('<H', len(entries))
    for tag, ty, count, value in entries:
        packed = (struct.pack('<HH', value, 0) if ty == 3
                  else struct.pack('<I', value))
        ifd += struct.pack('<HHI', tag, ty, count) + packed
    ifd += struct.pack('<I', 0)
    with open(path, 'wb') as f:
        f.write(b'II' + struct.pack('<HI', 42, ifd_off))
        f.write(img.astype('<u2' if img.dtype == np.uint16 else img.dtype,
                           copy=False).tobytes())
        f.write(ifd)


def ground_truth(h: int, w: int, rng) -> np.ndarray:
    """Broadband float32 texture in [0, 1): per-pixel noise over two
    coarse block scales, so phase correlation has signal at every
    frequency."""
    img = 0.35 * rng.random((h, w), dtype=np.float32)
    for block, weight in ((16, 0.35), (128, 0.30)):
        coarse = rng.random((h // block + 2, w // block + 2),
                            dtype=np.float32)
        img += weight * np.repeat(np.repeat(coarse, block, 0),
                                  block, 1)[:h, :w]
    return img


def vignette(n: int) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r2 = ((yy - c) ** 2 + (xx - c) ** 2) / (2 * c * c)
    return 1.0 - 0.35 * r2


def write_acquisition(folder: str, grid: int, tile: int, overlap: int,
                      jitter: int, seed: int) -> np.ndarray:
    """Write a Squid acquisition (one region, one timepoint, 3 channels)
    cut from a seeded ground truth with per-tile stage jitter and a
    vignette. Returns the ground truth."""
    rng = np.random.default_rng(seed)
    step = tile - overlap
    margin = 2 * jitter + 8
    side = step * (grid - 1) + tile + 2 * margin
    gt = ground_truth(side, side, rng)
    vig = vignette(tile)
    tdir = os.path.join(folder, "0")
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(folder, "acquisition parameters.json"), "w") as f:
        json.dump(ACQ_PARAMS, f, indent=2)
    rows = []
    for r in range(grid):
        for c in range(grid):
            fov = r * grid + c
            jy, jx = rng.integers(-jitter, jitter + 1, 2)
            y0, x0 = margin + r * step + jy, margin + c * step + jx
            window = gt[y0:y0 + tile, x0:x0 + tile] * vig
            for ci, ch in enumerate(CHANNELS):
                img = (window * (30000 + 8000 * ci) + 1500).astype(np.uint16)
                write_tiff(os.path.join(
                    tdir, f"A1_{fov}_0_{ch.replace(' ', '_')}.tiff"), img)
            rows.append(f"A1,{fov},0,{c * step / 1000.0:.6f},"
                        f"{r * step / 1000.0:.6f},0.0")
    with open(os.path.join(tdir, "coordinates.csv"), "w") as f:
        f.write("region,fov,z_level,x (mm),y (mm),z (um)\n")
        f.write("\n".join(rows) + "\n")
    return gt


# ----------------------------------------------------------- store compare

def read_level(store: str, level: int) -> np.ndarray:
    """Assemble one level of a raw (compressor-null) zarr v2 array from
    its chunk files with NumPy alone; missing chunks read as zeros."""
    path = os.path.join(store, str(level))
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    if meta["compressor"] is not None:
        raise ValueError(f"{path} is compressed; the smoke writes raw")
    shape, chunks = meta["shape"], meta["chunks"]
    dtype = np.dtype(meta["dtype"])
    out = np.zeros(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        fpath = os.path.join(path, *map(str, idx))
        if not os.path.exists(fpath):
            continue
        block = np.fromfile(fpath, dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


def compare_stores(dev: str, host: str, tol: int) -> dict:
    """Every pyramid level of two stores: same shape, |diff| <= tol."""
    levels = sorted(int(d) for d in os.listdir(dev) if d.isdigit())
    host_levels = sorted(int(d) for d in os.listdir(host) if d.isdigit())
    if levels != host_levels:
        raise AssertionError(f"levels differ: {levels} vs {host_levels}")
    worst, n_diff = 0, 0
    for lv in levels:
        a, b = read_level(dev, lv), read_level(host, lv)
        if a.shape != b.shape:
            raise AssertionError(f"level {lv}: {a.shape} vs {b.shape}")
        if lv == 0 and not a.any():
            raise AssertionError("level 0 is all zeros")
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        worst = max(worst, int(d.max()))
        n_diff += int(np.count_nonzero(d))
    if worst > tol:
        raise AssertionError(f"max |device - host| = {worst} LSB > {tol}")
    return {"levels": len(levels), "max_abs_diff_lsb": worst,
            "pixels_differing": n_diff, "tolerance_lsb": tol}


def region_store(pipe) -> str:
    return os.path.join(pipe.output_folder, "0_stitched",
                        "A1_stitched.ome.zarr")


# ------------------------------------------------------------------ runs

class Smoke:
    def __init__(self, args):
        self.args = args
        self.failed = []
        self.work = tempfile.mkdtemp(prefix="chip_smoke_")
        self.acq = os.path.join(self.work, "acq")

    @contextlib.contextmanager
    def phase(self, name: str):
        print(f"== phase: {name}", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"   FAILED: {name} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
        else:
            print(f"   ok: {name} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
        print_peak_memory()

    def stitch(self, name: str, resume_from=None, **option_kw):
        """One stitch through the public API into work/<name>; with
        ``resume_from`` (a finished pipeline) the run reuses its
        flatfields and registration from the run manifest and only
        fuses and writes."""
        from image_stitcher_tpu import EngineOptions, stitch
        from image_stitcher_tpu.utils.progress import ProgressReporter
        out = os.path.join(self.work, name)
        options = EngineOptions(compressor_cname=None, output_folder=out,
                                **option_kw)
        if resume_from is not None:
            os.makedirs(out)
            src = resume_from.output_folder
            with open(os.path.join(src, ".stitch_manifest.json")) as f:
                manifest = json.load(f)
            # keep the calibrations, redo every region with these options
            manifest.update(completed=[], finished=False, merges_done=False,
                            engine_options=options.output_fingerprint())
            with open(os.path.join(out, ".stitch_manifest.json"), "w") as f:
                json.dump(manifest, f)
            ff = os.path.join(src, "flatfields.npz")
            if os.path.exists(ff):
                shutil.copy(ff, out)
        status = []
        reporter = ProgressReporter(
            status=lambda msg, saving=False: status.append(msg),
            error=lambda msg: status.append(f"ERROR: {msg}"))
        t0 = time.perf_counter()
        pipe = stitch(self.acq, use_registration=True, apply_flatfield=True,
                      options=options, reporter=reporter,
                      resume=resume_from is not None)
        print(f"   {name}: {time.perf_counter() - t0:.2f}s wall", flush=True)
        for line in status:
            if line.startswith(("fusion backend", "stream stages",
                                "ERROR")):
                print(f"   {name}: {line}")
        for line in pipe.timers.summary():
            print(f"   {name} stage: {line}")
        pipe.status_lines = status
        return pipe

    def fixture(self):
        grid, tile, overlap, jitter = (REHEARSAL if self.args.rehearse
                                       else FULL)
        self.grid = grid
        with self.phase(f"fixture {grid}x{grid}x{len(CHANNELS)}ch "
                        f"{tile}^2 seed {self.args.seed}"):
            self.gt = write_acquisition(self.acq, grid, tile, overlap,
                                        jitter, self.args.seed)
            self.tile, self.overlap = tile, overlap

    def device_options(self, **kw):
        """On the CPU rehearsal, force the device code paths the GPU run
        takes by default (there 'auto' picks the host canvas, and the
        tiny canvas would not stream)."""
        if self.args.rehearse:
            kw.setdefault('fusion_device', 'device')
            kw.setdefault('streaming', 'on')
        return kw

    # (a) quick-start settings -------------------------------------------
    def run_a(self):
        with self.phase("(a) quick-start stitch on the device"):
            self.a_dev = self.stitch("a_device", **self.device_options())
            if (not self.args.rehearse
                    and "fusion backend: device"
                    not in self.a_dev.status_lines):
                raise AssertionError("fusion_device='auto' did not pick "
                                     "the device on a GPU")
        if "(a) quick-start stitch on the device" in self.failed:
            return
        with self.phase("(a) host reference + overwrite byte parity"):
            host = self.stitch("a_host", resume_from=self.a_dev,
                               fusion_device='host')
            res = compare_stores(region_store(self.a_dev),
                                 region_store(host), tol=0)
            print(f"   (a) overwrite parity: {res}")

    # (b) max-quality settings -------------------------------------------
    def run_b(self):
        from image_stitcher_tpu import EngineOptions, StitchingParameters
        from image_stitcher_tpu.io.acquisition import scan_acquisition
        from image_stitcher_tpu.models.pipeline import StitchPipeline
        quality = dict(registration_scope='global', blend_method='feather',
                       flatfield_device='device')
        if self.args.rehearse:
            # the rehearsal's 12 pairs would otherwise take the host twin
            quality['registration_device_threshold'] = 0
        name = "(b) global + feather + device flatfield on the device"
        with self.phase(name):
            self.b_dev = self.stitch("b_device",
                                     **self.device_options(**quality))
        if name in self.failed:
            return
        with self.phase("(b) registered shifts vs the f64 twin"):
            params = StitchingParameters(input_folder=self.acq,
                                         use_registration=True)
            twin = StitchPipeline(params, EngineOptions(
                compressor_cname=None, registration_scope='global',
                registration_device_threshold=10 ** 9))
            twin.acq = scan_acquisition(self.acq)
            twin.calculate_shifts_all_pairs(0, twin.acq.regions[0])
            n_pairs = 0
            worst = 0.0
            for kind in ('horizontal', 'vertical'):
                key = 'h_keys' if kind == 'horizontal' else 'v_keys'
                if self.b_dev.pair_shifts[key] != twin.pair_shifts[key]:
                    raise AssertionError(f"{kind} pair sets differ")
                dev = np.asarray(self.b_dev.pair_shifts[kind], np.float64)
                ref = np.asarray(twin.pair_shifts[kind], np.float64)
                n_pairs += len(ref)
                if len(ref):
                    worst = max(worst, float(np.abs(dev - ref).max()))
            print(f"   (b) {n_pairs} pairs: max |device - f64 twin| = "
                  f"{worst:.4f} px (tolerance {SHIFT_TOL_PX} px)")
            if worst > SHIFT_TOL_PX:
                raise AssertionError("registered shifts off the f64 twin")
        with self.phase("(b) device flatfields vs the host fit"):
            params = StitchingParameters(input_folder=self.acq,
                                         apply_flatfield=True)
            twin = StitchPipeline(params, EngineOptions(
                compressor_cname=None, flatfield_device='host'))
            twin.acq = scan_acquisition(self.acq)
            twin.compute_flatfields()
            worst = 0.0
            for idx, field in twin.flatfields.items():
                dev = self.b_dev.flatfields[idx]
                worst = max(worst, float(np.abs(dev - field).max()))
                np.testing.assert_allclose(dev, field, atol=FLATFIELD_TOL,
                                           rtol=FLATFIELD_TOL)
            print(f"   (b) {len(twin.flatfields)} flatfields: max |device - "
                  f"host| = {worst:.5f} (tolerance {FLATFIELD_TOL} abs + rel)")
        with self.phase("(b) host reference + feather parity"):
            host = self.stitch("b_host", resume_from=self.b_dev,
                               fusion_device='host',
                               **{k: v for k, v in quality.items()
                                  if k != 'flatfield_device'})
            res = compare_stores(region_store(self.b_dev),
                                 region_store(host), tol=FEATHER_TOL_LSB)
            print(f"   (b) feather parity: {res}")

    def precision_effect(self):
        """Shift error of the batched device kernel with and without
        HIGHEST precision on its upsampled-DFT products, against the
        known shifts and the f64 twin."""
        import jax
        import jax.numpy as jnp
        from image_stitcher_tpu.ops import phasecorr
        with self.phase("phasecorr precision: HIGHEST vs DEFAULT"):
            rng = np.random.default_rng(self.args.seed + 1)
            h = self.tile // 2
            w = max(16, int(self.overlap * 1.05))
            n = 128 if not self.args.rehearse else 16
            truth = rng.uniform(-4, 4, (n, 2))
            a = np.empty((n, h, w), np.float32)
            b = np.empty((n, h, w), np.float32)
            fy = np.fft.fftfreq(h)[:, None]
            fx = np.fft.fftfreq(w)[None, :]
            side = self.gt.shape[0]
            for i in range(n):
                y0, x0 = rng.integers(0, side - h), rng.integers(0, side - w)
                win = self.gt[y0:y0 + h, x0:x0 + w].astype(np.float64)
                phase = np.exp(-2j * np.pi * (fy * truth[i, 0]
                                              + fx * truth[i, 1]))
                a[i] = win
                b[i] = np.real(np.fft.ifft2(np.fft.fft2(win) * phase))
            ref = np.stack([phasecorr._pcc_np(a[i], b[i], 10)[0]
                            for i in range(n)])
            expect = -truth  # the registering shift undoes the applied one
            out = {}
            for label, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                                ("DEFAULT", jax.lax.Precision.DEFAULT)):
                fn = jax.jit(jax.vmap(lambda x, y, p=prec: phasecorr._pcc_core(
                    x, y, 10, precision=p)[0]))
                got = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
                out[label] = (float(np.abs(got - ref).max()),
                              float(np.abs(got - expect).max()))
                print(f"   precision {label}: max |device - f64 twin| = "
                      f"{out[label][0]:.4f} px, max |device - truth| = "
                      f"{out[label][1]:.4f} px ({n} pairs {h}x{w})")
            print(f"   f64 twin: max |twin - truth| = "
                  f"{float(np.abs(ref - expect).max()):.4f} px")
            if out["HIGHEST"][0] > SHIFT_TOL_PX:
                raise AssertionError("HIGHEST-precision shifts off the f64 "
                                     "twin")

    def gpu_tests(self):
        import pytest
        with self.phase("gpu-marked tests (in process)"):
            rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                              '-p', 'no:randomly',
                              os.path.join(REPO, 'tests', 'test_gpu.py')])
            if rc != 0:
                raise AssertionError(f"pytest exit code {rc}")

    # four cards ----------------------------------------------------------
    def run_four_cards(self):
        """Mesh (1, 4) against one card, in this process: overwrite
        byte-identical, feather within 1 LSB. Flatfields and
        registration come from the first run's manifest."""
        with self.phase("mesh (1, 4) overwrite stitch"):
            mesh = self.stitch("mesh_overwrite", mesh_shape=(1, 4))
        if self.failed:
            return
        with self.phase("one-card overwrite + byte parity"):
            one = self.stitch("one_overwrite", resume_from=mesh,
                              fusion_device='device')
            print(f"   overwrite mesh vs one card: "
                  f"{compare_stores(region_store(mesh), region_store(one), 0)}")
        with self.phase("mesh (1, 4) vs one-card feather"):
            mesh_f = self.stitch("mesh_feather", resume_from=mesh,
                                 mesh_shape=(1, 4), blend_method='feather')
            one_f = self.stitch("one_feather", resume_from=mesh,
                                fusion_device='device',
                                blend_method='feather')
            res = compare_stores(region_store(mesh_f), region_store(one_f),
                                 FEATHER_TOL_LSB)
            print(f"   feather mesh vs one card: {res}")


def print_peak_memory():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"   peak device memory: {stats['peak_bytes_in_use']} bytes "
              f"({stats['peak_bytes_in_use'] / 2 ** 30:.2f} GiB)")


def print_environment(rehearse: bool):
    import jax
    import jaxlib
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        cards = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        cards = []
    if not cards and not rehearse:
        raise RuntimeError("nvidia-smi reports no card")
    for card in cards or ["nvidia-smi: no card (rehearsal)"]:
        print(f"card: {card}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"python {sys.version.split()[0]}")
    import importlib
    for mod in ("tensorstore", "pandas", "cv2", "PIL"):
        try:
            importlib.import_module(mod)
            have = "available"
        except ImportError:
            have = "absent"
        print(f"optional package {mod}: {have}")
    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].device_kind} "
          f"({devs[0].platform})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny fixture; allow the CPU backend")
    ap.add_argument("--four-cards", action="store_true",
                    help="only the mesh (1, 4) stitch against one card")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "image_stitcher_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu' and not args.rehearse:
        print(f"no GPU: jax found {devs[0].platform!r} devices "
              "(use --rehearse for a CPU rehearsal)", file=sys.stderr)
        return 3
    if args.four_cards and len(devs) < 4:
        print(f"--four-cards needs 4 devices, found {len(devs)}",
              file=sys.stderr)
        return 3

    print_environment(args.rehearse)
    smoke = Smoke(args)
    print(f"work directory: {smoke.work}")
    try:
        smoke.fixture()
        if not smoke.failed:
            if args.four_cards:
                smoke.run_four_cards()
            else:
                smoke.run_a()
                smoke.run_b()
                smoke.precision_effect()
                smoke.gpu_tests()
    finally:
        shutil.rmtree(smoke.work, ignore_errors=True)
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
