"""StitchPipeline: the single stitching engine.

One functional core (register -> correct -> fuse as jitted ops over
batched tile tensors) behind a thin host orchestration layer, replacing
the reference's three divergent editions (stitcher.py, stitcher_process.py,
zarr_stitcher.py) with one code path. Public behavior parity:

- output tree  {out}/{t}_stitched/{region}_stitched{fmt}  (stitcher.py:56-61)
- registration measured once on the first timepoint's first region's
  center pairs (stitcher.py:1244-1246, 422-498)
- flatfield sampling budget and correction math (stitcher.py:365-419,607-611)
- placement/crop arithmetic via core.geometry (exact parity, see tests)
- OME-Zarr v0.4 multiscales + OMERO metadata (stitcher.py:771-859)
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..io.acquisition import Acquisition, read_image, scan_acquisition
from ..io.omezarr import MultiscaleWriter
from ..io.readers import (TileBatchLoader, TileJob, expand_tile_jobs,
                          load_tile_plane)
from ..ops import fuse as fuse_ops
from ..ops import pyramid as pyr_ops
from ..ops.phasecorr import (horizontal_shift_from_pcc,
                             vertical_shift_from_pcc)
from ..params import EngineOptions, StitchingParameters
from ..utils.profiling import StageTimers
from ..utils.progress import ProgressReporter, StitchCancelled

#: serializes the lazy compressor-'auto' probe across merge workers
_COMPRESSOR_PROBE_LOCK = threading.Lock()


def _deprioritize_thread():
    """Nice (+5) the calling thread: flatfield sample/fit work runs
    concurrently with fusion, which is partly IO-blocked — deprioritized
    prep fills those gaps instead of stealing runnable time on starved
    hosts. Per-thread on Linux (setpriority takes the TID); harmless
    no-op elsewhere."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 5)
    except (AttributeError, OSError):
        pass


def auto_fusion_backend() -> str:
    """What ``fusion_device='auto'`` picks: the device canvas on a GPU,
    the threaded host canvas on the CPU backend (where the 'device' is
    the host itself)."""
    return 'device' if jax.default_backend() == 'gpu' else 'host'


class StitchPipeline:
    """Orchestrates a full stitching run for one acquisition."""

    def __init__(self, params: StitchingParameters,
                 options: Optional[EngineOptions] = None,
                 reporter: Optional[ProgressReporter] = None,
                 stop_event=None, resume: bool = False):
        params.validate()
        self.params = params
        self.options = options or EngineOptions()
        self.options.validate()
        self.reporter = reporter or ProgressReporter()
        self.stop_event = stop_event

        self.input_folder = params.input_folder
        self.resumed = False
        if self.options.output_folder is not None:
            # explicit folder pins the destination; resuming into it
            # still requires the same params/output-fingerprint check
            # find_resumable enforces — without it, a re-run with
            # different blend/chunks/compressor would silently mix
            # settings in one tree (and run() would then overwrite the
            # manifest's fingerprint, hiding the mismatch for good)
            self.output_folder = self.options.output_folder
            if resume:
                from ..utils.manifest import RunManifest
                shard = self.options.work_shard
                m = RunManifest.load(
                    self.output_folder,
                    suffix=f".shard{shard[0]}" if shard is not None else "")
                # a finished manifest is fine here: re-running a pinned
                # folder with --resume (supervisor restarts of work
                # shards) skips every completed unit — an idempotent
                # no-op, unlike the timestamped-folder flow where
                # find_resumable starts a fresh run instead
                if m is not None and not m.compatible_with(
                        params.to_dict(), self.options.output_fingerprint()):
                    raise ValueError(
                        f"refusing to resume into {self.output_folder}: "
                        f"its manifest was written with different "
                        f"parameters or output-affecting options")
                # no manifest yet = resuming into a folder nothing has
                # written: behaves as a fresh run under the old flag
                self.resumed = True
        elif resume:
            from ..utils.manifest import find_resumable
            prior = find_resumable(self.input_folder, params.to_dict(),
                                   self.options.output_fingerprint())
            if prior is not None:
                self.output_folder = prior
                self.resumed = True
                self.reporter.status(f"Resuming run in {prior}", False)
            else:
                self.output_folder = params.stitched_folder
        else:
            self.output_folder = params.stitched_folder  # timestamp once
        self.output_format = params.output_format
        self.per_timepoint_region_output_template = os.path.join(
            self.output_folder, "{timepoint}_stitched",
            "{region}_stitched" + self.output_format)

        self.acq: Optional[Acquisition] = None
        self.flatfields: Dict[int, np.ndarray] = {}
        self._ff_recip_np_cache: Optional[np.ndarray] = None
        self._ff_recip_dev_cache = None
        self._ff_gate = None        # per-channel gate for overlapped fits
        self._ff_future = None      # in-flight overlapped fit, if any
        self._manifest = None
        self.shifts = geo.RegistrationShifts(scan_pattern=params.scan_pattern)
        self.num_pyramid_levels = 1
        self.registration_channel = params.registration_channel
        self.saved_paths: List[str] = []
        self.global_positions: Dict = {}
        self.global_positions_float: Dict = {}
        self.registration_reports: Dict[str, Dict] = {}
        self._global_rejected: set = set()  # regions whose solve failed
        # the canvas sanity clamp (grid-model fallback, no re-solve)
        self.timers = StageTimers()

    # ------------------------------------------------------------------ util

    def _check_stop(self):
        if self.stop_event is not None and self.stop_event.is_set():
            raise StitchCancelled("stitching cancelled")

    def _shard_barrier(self):
        """Wait for every cooperating process (multi-controller runs);
        a single-process work-sharded run (sequential shards) no-ops.

        Bounded: the wait uses the distributed coordination service's
        timed barrier so a shard that crashed before reaching the merge
        point FAILS this process with recovery guidance instead of
        deadlocking it forever (sync_global_devices has no timeout)."""
        if jax.process_count() <= 1:
            return
        timeout_s = self.options.merge_barrier_timeout_s
        try:
            # the coordination-service barrier is only reachable through
            # a private module (no public timed-barrier API as of jax
            # 0.4-0.7); the import is version-guarded so any internal
            # rename degrades to the timed-thread fallback below instead
            # of breaking multi-controller runs
            client = None
            try:
                from jax._src import distributed as _dist
                client = _dist.global_state.client
            except Exception:
                client = None
            if client is not None and timeout_s:
                client.wait_at_barrier("stitch_merge_barrier",
                                       timeout_in_ms=int(timeout_s * 1000))
            else:
                self._sync_devices_timed(timeout_s)
        except Exception as e:
            raise RuntimeError(
                "pre-merge shard barrier failed (timeout "
                f"{timeout_s:.0f}s) — a cooperating shard likely died "
                "before reaching the merge point. Recovery: re-run the "
                "dead shard with --resume into the same output folder "
                "(it skips its completed units), then re-run the "
                "coordinator shard with --resume to complete the "
                f"merges. (cause: {e})") from e

    @staticmethod
    def _sync_devices_timed(timeout_s: float):
        """sync_global_devices with a deadline: the collective itself has
        no timeout, so it runs on a daemon thread and a wait that expires
        raises here (the stuck thread is abandoned — this process is
        about to fail with recovery guidance anyway). ``timeout_s`` 0 or
        None keeps the reference untimed behavior."""
        from jax.experimental import multihost_utils
        if not timeout_s:
            multihost_utils.sync_global_devices("stitch_merge_barrier")
            return
        import threading
        done = threading.Event()
        err: List[BaseException] = []

        def wait():
            try:
                multihost_utils.sync_global_devices("stitch_merge_barrier")
            except BaseException as e:
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=wait, name='merge-barrier', daemon=True)
        t.start()
        if not done.wait(timeout_s):
            raise TimeoutError(
                f"barrier not reached within {timeout_s:.0f}s")
        if err:
            raise err[0]

    def _dtype_max(self) -> float:
        dt = self.acq.dtype
        return float(np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0

    # ----------------------------------------------------------- flatfields

    def compute_flatfields(self):
        """Sample tiles per channel and fit flatfields on device.

        Sampling budget parity with reference stitcher.py:381-394:
        up to 32 random tiles per timepoint, stop once >48 collected.
        Samples read in parallel; host and device solvers fit the same
        stack (the device compiles once per distinct sample count).
        """
        from concurrent.futures import ThreadPoolExecutor
        acq = self.acq
        self.reporter.getting_flatfields()
        # new fits invalidate any cached reciprocal stack
        self._ff_recip_np_cache = None
        self._ff_recip_dev_cache = None
        opts = self.options
        rnd = random.Random(0)
        pool = ThreadPoolExecutor(opts.resolved_reader_threads(),
                                  initializer=_deprioritize_thread)
        try:
            self._compute_flatfields_inner(acq, opts, rnd, pool)
        finally:
            pool.shutdown(wait=False)

    def _compute_flatfields_inner(self, acq, opts, rnd, pool):
        from ..ops.flatfield import (finalize_flatfield, fit_flatfield_stack,
                                     fit_flatfield_stack_np,
                                     load_sample_small)
        use_device = opts.flatfield_device == 'device'
        out_hw = (acq.input_height, acq.input_width)

        def fit(stack2d: np.ndarray) -> np.ndarray:
            if use_device:
                import jax.numpy as _jnp
                s = np.asarray(fit_flatfield_stack(_jnp.asarray(stack2d)))
            else:
                s = fit_flatfield_stack_np(stack2d)
            return finalize_flatfield(s, out_hw)

        # channel solves are independent; on the host path run them in
        # parallel (scipy/numpy release the GIL in the hot ops — ~Nx on
        # multi-core hosts, harmless on one core). The device path stays
        # sequential on the single accelerator. Fits are submitted AS
        # each channel's sample stack finishes loading, with at most
        # pool-width stacks in flight — collecting every channel's stack
        # before the first fit would multiply peak memory by the channel
        # count on wide acquisitions.
        done = [0]

        def record(idx, field):
            self.flatfields[idx] = field
            if self._ff_gate is not None:
                self._ff_gate.publish(idx, field)
            done[0] += 1
            self.reporter.update_progress(done[0], acq.num_c)

        from concurrent.futures import ThreadPoolExecutor as _TPE
        from ..params import _available_cpus
        # cap at the schedulable CPUs: a one-core host keeps the
        # sequential order (and one-fit cancellation latency)
        workers = (1 if use_device else
                   max(1, min(len(acq.monochrome_channels), 4,
                              _available_cpus())))
        fit_pool = (_TPE(workers, initializer=_deprioritize_thread)
                    if workers > 1 else None)
        futures = []   # (monochrome idx, future), submit order
        drained = 0    # prefix of futures already recorded

        def drain_until(max_in_flight):
            nonlocal drained
            while len(futures) - drained > max_in_flight:
                idx0, fut0 = futures[drained]
                self._check_stop()
                record(idx0, fut0.result())
                drained += 1

        def dispatch(idx, stack2d):
            if fit_pool is None:
                self._check_stop()
                record(idx, fit(stack2d))
                return
            futures.append((idx, fit_pool.submit(fit, stack2d)))
            # backpressure: keep at most pool-width stacks in flight so
            # loading can't outrun fitting into unbounded queued stacks
            drain_until(workers)

        try:
            for channel in acq.channel_names:
                self._check_stop()
                paths = []
                for t in acq.timepoints:
                    t_paths = [rec.filepath for key, rec in acq.tiles.items()
                               if rec.channel == channel and key[0] == int(t)]
                    if not t_paths:
                        continue
                    rnd.shuffle(t_paths)
                    paths.extend(
                        t_paths[:min(opts.flatfield_tiles_per_timepoint,
                                     len(t_paths))])
                    if len(paths) > opts.flatfield_max_tiles:
                        break
                if not paths:
                    continue
                # The reference's worst-case collection: the >48 break
                # fires after adding a full timepoint, so <= 48+32
                # samples (stitcher.py:389-394). Samples are read
                # decimated straight to the fit's working resolution —
                # never at full size.
                target = (opts.flatfield_max_tiles
                          + opts.flatfield_tiles_per_timepoint)
                paths = paths[:target]
                # host and device solve the SAME stack: the ADMM's
                # DCT threshold scales with the stack size, so padding
                # one twin's stack would change its field
                small = np.stack(list(pool.map(load_sample_small, paths)))
                if small.ndim == 4 and small.shape[-1] == 3:
                    base = channel.split('_')[0]
                    for plane, suffix in enumerate('RGB'):
                        idx = acq.monochrome_channels.index(
                            f"{base}_{suffix}")
                        dispatch(idx, small[..., plane])
                elif small.ndim == 3:
                    dispatch(acq.monochrome_channels.index(channel), small)
                # drop the loop's reference: in-flight futures hold the
                # only remaining one, so the stack frees when its fits do
                small = None
            drain_until(0)
        except BaseException:
            for _idx, fut in futures:
                fut.cancel()
            raise
        finally:
            if fit_pool is not None:
                fit_pool.shutdown(wait=True)
        self._check_stop()

    def resolved_compressor(self):
        """(cname, clevel, shuffle) for the zarr writers. 'auto' stores
        RAW unless BOTH gates pass: the median zlib-1 probe ratio over
        first/center/last tiles is <= 0.6 (content genuinely
        compresses; zlib-1 under-reports blosc's achieved ratio), and
        the measured output-device bandwidth is < 300 MB/s x cores (the
        disk, not the CPU, is the bottleneck — on a fast-disk host lz4
        burns the cores AND forfeits the raw O_DIRECT writer; not
        measured on the GPU host). Cached per run so every writer
        (regions + merges) agrees."""
        opts = self.options
        if opts.compressor_cname != 'auto':
            return (opts.compressor_cname, opts.compressor_clevel,
                    opts.compressor_shuffle)
        # parallel merge workers may reach this concurrently; the lock
        # keeps the probe a one-shot (run_merges also warms it on the
        # main thread before any pool starts)
        with _COMPRESSOR_PROBE_LOCK:
            return self._resolved_compressor_locked()

    def _resolved_compressor_locked(self):
        opts = self.options
        if getattr(self, '_compressor_choice', None) is None:
            from ..io.zarr_store import have_tensorstore
            if not have_tensorstore():
                self._compressor_choice = (None, 0, 0)
                self.reporter.status(
                    "compressor auto: tensorstore not installed — storing "
                    "raw chunks", False)
                return self._compressor_choice
            import zlib
            # Probe first/center/last tiles (in key order) and decide on
            # the MEDIAN ratio: one atypically noisy tile on an otherwise
            # compressible plate must not commit the whole run — all
            # regions, merges, pyramid levels — to raw storage.
            keys = sorted(self.acq.tiles.keys())
            picks = sorted({0, len(keys) // 2, len(keys) - 1})
            ratios = []
            probed = []
            for i in picks:
                rec = self.acq.tiles[keys[i]]
                flat = np.ravel(read_image(rec.filepath))
                raw = np.ascontiguousarray(
                    flat[:(1 << 20) // flat.itemsize]).tobytes()
                ratios.append(len(zlib.compress(raw, 1)) / max(1, len(raw)))
                probed.append(os.path.basename(rec.filepath))
            ratio = float(np.median(ratios))
            detail = ", ".join(f"{n}={r:.2f}"
                               for n, r in zip(probed, ratios))
            # lz4 pays twice: compress CPU through the tensorstore
            # writer AND the detour off the raw O_DIRECT pwritev fast
            # path (tools/ab_compressor.py compares the two; not
            # measured on the GPU host). So compression must clear TWO
            # gates: content that genuinely compresses (the zlib-1
            # probe under-reports blosc's achieved ratio, hence 0.6 not
            # 0.92) and a disk slow enough that shrinking bytes beats
            # burning cores (per-core compressor throughput x cores).
            reason = None
            if ratio > 0.6:
                reason = "content doesn't compress enough"
            else:
                from ..params import _available_cpus
                disk = self._probed_disk_mbps()
                ncores = _available_cpus()
                if disk is not None and disk >= 300.0 * ncores:
                    reason = (f"disk {disk:.0f} MB/s outruns "
                              f"{ncores}-core lz4")
            if reason is not None:
                self._compressor_choice = (None, 0, 0)
                self.reporter.status(
                    f"compressor auto: median ratio {ratio:.2f} "
                    f"({detail}) — storing raw chunks ({reason})", False)
            else:
                self._compressor_choice = ('lz4', 5, 1)
                self.reporter.status(
                    f"compressor auto: median ratio {ratio:.2f} "
                    f"({detail}) — blosc-lz4-5", False)
        return self._compressor_choice

    def _probed_disk_mbps(self):
        """Measured write bandwidth of the output device (best of the
        cached buffered/direct probe arms), or None when there is no
        real measurement — unprobed, probe failure, or the probe's
        O_DIRECT-unsupported sentinel (0.0 rates on tmpfs/FUSE) — so
        the decision degrades to the ratio gate alone."""
        try:
            from ..io.directio import probe_direct_io
            d = os.path.dirname(self.output_folder) or '.'
            entry = probe_direct_io(d)
            if entry:
                best = max(float(entry.get('buffered_mbps', 0.0)),
                           float(entry.get('direct_mbps', 0.0)))
                if best > 0.0:
                    return best
        except Exception:
            pass
        return None

    def _await_ff(self):
        """Join the overlapped flatfield fit (no-op when none is in
        flight) and surface its error. Every consumer of the COMPLETE
        field set funnels through here; only the per-channel-gated
        streaming fuser may read earlier. Persistence happens on the
        fit thread itself (atomic rename)."""
        fut = self._ff_future
        if fut is None:
            return
        fut.result()  # a failed fit re-raises on every later call too
        self._ff_future = None

    def _ff_recip_or_none(self) -> Optional[np.ndarray]:
        """Complete reciprocal stack, or None when nothing was fitted
        (checking ``self.flatfields`` before the overlapped fit joins
        would race the fit thread filling it)."""
        self._await_ff()
        return self._flatfield_recip_np() if self.flatfields else None

    def _flatfield_recip_np(self) -> np.ndarray:
        """(C, th, tw) f32 RECIPROCAL flatfield stack; ones where no
        field was fitted. Computed once on the host so every backend
        multiplies the identical values (a device divide may be
        reciprocal-approximated; host-side reciprocal + multiply is
        bit-exact everywhere, see ops.fuse.apply_flatfield).

        Cached for the run: flatfields are fixed once compute_flatfields
        (or the resume sidecar load) finishes, and rebuilding a ~C*HW*4-
        byte stack per region (100 regions = 100 divides and, on the
        device path, 100 identical H2D uploads) is pure waste."""
        if self._ff_recip_np_cache is not None:
            return self._ff_recip_np_cache
        self._await_ff()  # the full stack needs every channel's fit
        acq = self.acq
        ff = np.ones((acq.num_c, acq.input_height, acq.input_width), np.float32)
        for idx, field in self.flatfields.items():
            ff[idx] = 1.0 / field
        self._ff_recip_np_cache = ff
        return ff

    def _flatfield_recip(self) -> jnp.ndarray:
        """(C, th, tw) f32 reciprocal device stack (cached per run)."""
        if self._ff_recip_dev_cache is None:
            self._ff_recip_dev_cache = jnp.asarray(self._flatfield_recip_np())
        return self._ff_recip_dev_cache

    # ---------------------------------------------------------- registration

    def _get_tile_image(self, t, region, x, y, channel, z_level) -> Optional[np.ndarray]:
        rec = self.acq.find_tile(t, region, x, y, channel, z_level)
        if rec is None:
            return None
        img = read_image(rec.filepath)
        if img.ndim == 3:  # RGB registration channel: correlate plane 0
            img = img[..., 0]
        return img

    def _measure_pair(self, img_a: np.ndarray, img_b: np.ndarray,
                      axis: str, max_overlap: int, debug_name: str = '') -> np.ndarray:
        """Normalize, crop overlap strips, run subpixel phase correlation.

        Strip geometry parity with reference stitcher.py:500-524
        (25% margin on the orthogonal axis).
        """
        from ..ops.phasecorr import normalize_to_dtype_range_np
        dmax = self._dtype_max()
        # Host-side min-max normalize (reference stitcher.py:613-617):
        # cheap vector math; keeps full-resolution images off the link —
        # only the overlap strips are shipped to the device.
        a = normalize_to_dtype_range_np(img_a, dmax)
        b = normalize_to_dtype_range_np(img_b, dmax)
        margin_frac = self.options.registration_margin
        if axis == 'horizontal':
            margin = int(a.shape[0] * margin_frac)
            lo, hi = margin, a.shape[0] - margin
            strip_a = a[lo:hi, -max_overlap:]
            strip_b = b[lo:hi, :max_overlap]
        else:
            margin = int(a.shape[1] * margin_frac)
            lo, hi = margin, a.shape[1] - margin
            strip_a = a[-max_overlap:, lo:hi]
            strip_b = b[:max_overlap, lo:hi]
        if self.options.debug_visuals:
            self._visualize_strips(strip_a, strip_b, debug_name or axis)
        # One-shot pair: host FFT (the batched all-pairs scope uses the
        # jitted device kernel, calculate_shifts_all_pairs).
        from ..ops.phasecorr import phase_cross_correlation_np
        shift = phase_cross_correlation_np(
            strip_a, strip_b, upsample_factor=self.options.upsample_factor)
        return np.asarray(shift), strip_a.shape

    def _visualize_strips(self, s1: np.ndarray, s2: np.ndarray, title: str):
        """Debug strip PNGs (reference stitcher.py:619-637)."""
        try:
            import cv2
            combined = np.hstack((s1, s2)) if title.startswith('horizontal') \
                else np.vstack((s1, s2))
            img8 = (combined / self._dtype_max() * 255).astype(np.uint8)
            os.makedirs(self.output_folder, exist_ok=True)
            cv2.imwrite(os.path.join(self.output_folder, f"{title}.png"), img8)
        except Exception as e:
            print(f"Error in visualize_image: {e}")

    def calculate_shifts(self, t, region: str):
        """Measure h/v (and S-Pattern reverse-h) shifts at the grid center.

        Parity with reference calculate_shifts (stitcher.py:422-498).
        """
        self._check_stop()
        acq = self.acq
        if not self.registration_channel:
            self.registration_channel = acq.channel_names[0]
        elif self.registration_channel not in acq.channel_names:
            self.registration_channel = acq.channel_names[0]
        z_level = self.params.registration_z_level

        xs, ys = acq.region_positions(int(t), region)
        h_shift: geo.Shift = (0, 0)
        v_shift: geo.Shift = (0, 0)
        h_shift_rev: geo.Shift = (0, 0)
        h_shift_rev_odd = 0

        dx_px = (xs[1] - xs[0]) * 1000 / acq.pixel_size_um if len(xs) > 1 else 0.0
        dy_px = (ys[1] - ys[0]) * 1000 / acq.pixel_size_um if len(ys) > 1 else 0.0
        max_x_overlap = geo.overlap_estimate(acq.input_width, dx_px,
                                             acq.pixel_binning,
                                             self.options.overlap_fudge)
        max_y_overlap = geo.overlap_estimate(acq.input_height, dy_px,
                                             acq.pixel_binning,
                                             self.options.overlap_fudge)

        cx = geo.grid_center_pair_indices(len(xs))
        cy = geo.grid_center_pair_indices(len(ys))
        center_x, center_y = xs[cx], ys[cy]
        right_x = xs[cx + 1] if cx + 1 < len(xs) else None
        bottom_y = ys[cy + 1] if cy + 1 < len(ys) else None
        ch = self.registration_channel

        if right_x is not None and max_x_overlap > 0:
            a = self._get_tile_image(t, region, center_x, center_y, ch, z_level)
            b = self._get_tile_image(t, region, right_x, center_y, ch, z_level)
            if a is not None and b is not None:
                shift, (sh, sw) = self._measure_pair(a, b, 'horizontal', max_x_overlap)
                h_shift = horizontal_shift_from_pcc(shift, sw)

        if bottom_y is not None and max_y_overlap > 0:
            a = self._get_tile_image(t, region, center_x, center_y, ch, z_level)
            b = self._get_tile_image(t, region, center_x, bottom_y, ch, z_level)
            if a is not None and b is not None:
                shift, (sh, sw) = self._measure_pair(a, b, 'vertical', max_y_overlap)
                v_shift = vertical_shift_from_pcc(shift, sh)

        if (self.params.scan_pattern == 'S-Pattern' and right_x is not None
                and bottom_y is not None and max_x_overlap > 0):
            a = self._get_tile_image(t, region, center_x, bottom_y, ch, z_level)
            b = self._get_tile_image(t, region, right_x, bottom_y, ch, z_level)
            if a is not None and b is not None:
                shift, (sh, sw) = self._measure_pair(a, b, 'horizontal',
                                                     max_x_overlap,
                                                     'horizontal_rev')
                h_shift_rev = horizontal_shift_from_pcc(shift, sw)
                h_shift_rev_odd = int(cy % 2 == 0)

        self.shifts = geo.RegistrationShifts(
            h_shift=h_shift, v_shift=v_shift, h_shift_rev=h_shift_rev,
            h_shift_rev_odd=h_shift_rev_odd,
            scan_pattern=self.params.scan_pattern)
        if self.options.registration_report:
            self.registration_reports[str(region)] = {
                'scope': 'center',
                'channel': self.registration_channel,
                'z_level': z_level,
                'aggregated': {'h_shift': list(h_shift),
                               'v_shift': list(v_shift),
                               'h_shift_rev': list(h_shift_rev),
                               'h_shift_rev_odd': h_shift_rev_odd},
            }

    def calculate_shifts_all_pairs(self, t, region: str):
        """Robust full-grid registration: EVERY adjacent pair measured.

        Upgrade over the reference's single-center-pair estimate
        (stitcher.py:456-485): all horizontal and vertical neighbor
        strips are registered in one batched vmapped phase-correlation
        call, then aggregated by median (parity-split for S-Pattern
        rows). Falls back to the center-pair scope via
        EngineOptions.registration_scope = 'center'.
        """
        from ..ops.phasecorr import (phase_cross_correlation_conf_batch,
                                     phase_cross_correlation_conf_np)
        self._check_stop()
        acq = self.acq
        if not self.registration_channel or \
                self.registration_channel not in acq.channel_names:
            self.registration_channel = acq.channel_names[0]
        ch = self.registration_channel
        z_level = self.params.registration_z_level

        xs, ys = acq.region_positions(int(t), region)
        n_cols, n_rows = len(xs), len(ys)
        dx_px = (xs[1] - xs[0]) * 1000 / acq.pixel_size_um if n_cols > 1 else 0.0
        dy_px = (ys[1] - ys[0]) * 1000 / acq.pixel_size_um if n_rows > 1 else 0.0
        ox = geo.overlap_estimate(acq.input_width, dx_px, acq.pixel_binning,
                                  self.options.overlap_fudge)
        oy = geo.overlap_estimate(acq.input_height, dy_px, acq.pixel_binning,
                                  self.options.overlap_fudge)
        mfrac = self.options.registration_margin
        my = int(acq.input_height * mfrac)
        mx = int(acq.input_width * mfrac)

        # Pair strips stream through BOUNDED batches (O(batch) memory,
        # not O(grid)): a 20x20 region holds 760 pairs whose strips
        # would otherwise sit in four full (N_pairs, sh, overlap)
        # arrays at once. Each batch reads the tiles it needs (threaded,
        # mmap-backed — only the strip pages are touched) and writes
        # RAW overlap strips STRAIGHT into the batch arrays. Unlike the
        # center-pair parity path, no normalization happens here: phase
        # correlation whitens the cross-power spectrum, so a per-image
        # affine rescale cannot move the peak — skipping it avoids a
        # full-image min/max + float materialization per tile and ships
        # half the bytes (u16) to the device kernel.
        from concurrent.futures import ThreadPoolExecutor

        recs = {(r, c): acq.find_tile(t, region, xs[c], ys[r], ch, z_level)
                for r in range(n_rows) for c in range(n_cols)}
        h_keys = ([(r, c) for r in range(n_rows) for c in range(n_cols - 1)
                   if recs[(r, c)] and recs[(r, c + 1)]] if ox else [])
        v_keys = ([(r, c) for r in range(n_rows - 1) for c in range(n_cols)
                   if recs[(r, c)] and recs[(r + 1, c)]] if oy else [])
        sh_h = max(acq.input_height - 2 * my, 1)
        sw_v = max(acq.input_width - 2 * mx, 1)
        dt = acq.dtype

        def _fill(dst, src) -> bool:
            """Copy src into dst's top-left; True if src underfills it
            (a truncated tile — the zero remainder would otherwise feed
            the correlator a confident-looking wrong answer)."""
            s0 = min(dst.shape[0], src.shape[0])
            s1 = min(dst.shape[1], src.shape[1])
            dst[:s0, :s1] = src[:s0, :s1]
            return s0 < dst.shape[0] or s1 < dst.shape[1]

        def batch_measure(a_batch, b_batch):
            """(N, sh, sw) strip batches -> (shifts, confidences).

            Small batches run the host (f64 SciPy) twin — a one-shot
            device compile can cost more than the whole measurement;
            large batches amortize the jitted kernel.
            """
            n = len(a_batch)
            if n == 0:
                return [], []
            if n <= self.options.registration_device_threshold:
                out = [phase_cross_correlation_conf_np(
                    a_batch[i], b_batch[i], self.options.upsample_factor)
                    for i in range(n)]
                return ([np.asarray(s) for s, _ in out],
                        [float(c) for _, c in out])
            shifts, peaks = phase_cross_correlation_conf_batch(
                jnp.asarray(a_batch), jnp.asarray(b_batch),
                self.options.upsample_factor)
            return list(np.asarray(shifts)), list(np.asarray(peaks))

        batch_pairs = max(1, self.options.registration_batch_pairs)
        self._registration_peak_strip_bytes = 0

        def measure_streamed(keys, kind):
            """Stream `keys` through bounded batches.

            Returns (kept_keys, shifts, confs, n_dropped). Memory held
            at any moment: two (batch, sh, sw) strip arrays. Short
            final batches on the device path are padded to the batch
            size so every dispatch reuses the one compiled shape.
            """
            if not keys:
                return [], [], [], 0
            shape = (sh_h, ox) if kind == 'h' else (oy, sw_v)
            kept, shifts, confs = [], [], []
            dropped = 0
            full_dispatched = False
            for start in range(0, len(keys), batch_pairs):
                chunk = list(keys[start:start + batch_pairs])
                n = len(chunk)
                a = np.zeros((n,) + shape, dt)
                b = np.zeros((n,) + shape, dt)
                partial = np.zeros(n, bool)
                # tile -> [(slot, side)]: each batch reads each tile once
                needs: dict = {}
                for i, (r, c) in enumerate(chunk):
                    other = (r, c + 1) if kind == 'h' else (r + 1, c)
                    needs.setdefault((r, c), []).append((i, 'a'))
                    needs.setdefault(other, []).append((i, 'b'))

                def load(rc):
                    self._check_stop()  # cooperative cancel per tile
                    rec = recs.get(rc)
                    if rec is None:
                        return
                    # whole-file readahead only for the h pass: its
                    # column strips fault nearly every page anyway (a
                    # 4 KB page spans about one tile row). The v pass
                    # needs only ~2*oy contiguous rows per tile — the
                    # kernel's own readahead covers those, and a
                    # whole-file WILLNEED would re-pull each full tile
                    # a second time after the h pass already did
                    img = read_image(rec.filepath, prefer_mmap=True,
                                     prefetch=(kind == 'h'))
                    if img.ndim == 3:
                        img = img[..., 0]
                    h_img, w_img = img.shape
                    for i, side in needs[rc]:
                        if kind == 'h':
                            src = (img[my:h_img - my, -ox:] if side == 'a'
                                   else img[my:h_img - my, :ox])
                        else:
                            src = (img[-oy:, mx:w_img - mx] if side == 'a'
                                   else img[:oy, mx:w_img - mx])
                        # store-only-True: both sides of a pair run on
                        # different pool threads; a |= read-modify-write
                        # could overwrite a True with a stale False
                        if _fill((a if side == 'a' else b)[i], src):
                            partial[i] = True

                with ThreadPoolExecutor(
                        self.options.resolved_reader_threads()) as pool:
                    list(pool.map(load, list(needs.keys())))
                self._registration_peak_strip_bytes = max(
                    self._registration_peak_strip_bytes,
                    a.nbytes + b.nbytes)

                # pairs touching a truncated tile measure garbage
                # against the zero padding: drop them (the grid model
                # covers those cells)
                if partial.any():
                    dropped += int(partial.sum())
                    keep = ~partial
                    a, b = a[keep], b[keep]
                    chunk = [k for k, kp in zip(chunk, keep) if kp]
                    n = len(chunk)
                if n == 0:
                    continue
                self._check_stop()
                if (full_dispatched and n < batch_pairs
                        and n > self.options.registration_device_threshold):
                    # pad with repeats of pair 0 to reuse the compiled
                    # (batch_pairs, sh, sw) kernel; discard pad results
                    pad = batch_pairs - n
                    s_, c_ = batch_measure(
                        np.concatenate([a, np.repeat(a[:1], pad, 0)]),
                        np.concatenate([b, np.repeat(b[:1], pad, 0)]))
                    s_, c_ = s_[:n], c_[:n]
                else:
                    s_, c_ = batch_measure(a, b)
                full_dispatched = full_dispatched or n == batch_pairs
                kept.extend(chunk)
                shifts.extend(s_)
                confs.extend(c_)
            return kept, shifts, confs, dropped

        self._check_stop()
        h_keys, h_shifts, h_conf, dropped_h = measure_streamed(h_keys, 'h')
        v_keys, v_shifts, v_conf, dropped_v = measure_streamed(v_keys, 'v')
        if dropped_h or dropped_v:
            self.reporter.status(
                f"registration: dropping {dropped_h} horizontal"
                f" + {dropped_v} vertical pair(s) touching"
                " truncated tiles", False)
        h_tags = [k[0] for k in h_keys]
        self.pair_shifts = {'horizontal': h_shifts, 'vertical': v_shifts,
                            'h_keys': h_keys, 'v_keys': v_keys,
                            'h_conf': h_conf, 'v_conf': v_conf}

        def agg_h(shifts):
            if not shifts:
                return (0, 0)
            arr = np.stack(shifts)
            med = np.median(arr, axis=0)
            return (round(float(med[0])), round(float(med[1]) - ox))

        def agg_v(shifts):
            if not shifts:
                return (0, 0)
            arr = np.stack(shifts)
            med = np.median(arr, axis=0)
            return (round(float(med[0]) - oy), round(float(med[1])))

        if self.params.scan_pattern == 'S-Pattern' and h_shifts:
            even = [s for s, r in zip(h_shifts, h_tags) if r % 2 == 0]
            odd = [s for s, r in zip(h_shifts, h_tags) if r % 2 == 1]
            h_shift = agg_h(even) if even else (0, 0)
            h_shift_rev = agg_h(odd) if odd else h_shift
            h_shift_rev_odd = 1
        else:
            h_shift = agg_h(h_shifts)
            h_shift_rev = (0, 0)
            h_shift_rev_odd = 0

        self.shifts = geo.RegistrationShifts(
            h_shift=h_shift, v_shift=agg_v(v_shifts),
            h_shift_rev=h_shift_rev, h_shift_rev_odd=h_shift_rev_odd,
            scan_pattern=self.params.scan_pattern)

        report = None
        if self.options.registration_report:
            def pair_records(keys, shifts, confs, direction, d_rc):
                return [{'a': [r, c], 'b': [r + d_rc[0], c + d_rc[1]],
                         'direction': direction,
                         'dy': float(s[0]), 'dx': float(s[1]),
                         'confidence': float(cf)}
                        for (r, c), s, cf in zip(keys, shifts, confs)]
            report = {
                'scope': self.options.registration_scope,
                'channel': ch, 'z_level': z_level,
                'strip_overlap': {'horizontal': int(ox), 'vertical': int(oy)},
                'pairs_dropped_truncated': dropped_h + dropped_v,
                'aggregated': {'h_shift': list(self.shifts.h_shift),
                               'v_shift': list(self.shifts.v_shift),
                               'h_shift_rev': list(self.shifts.h_shift_rev),
                               'h_shift_rev_odd': h_shift_rev_odd},
                'pairs': pair_records(h_keys, h_shifts, h_conf,
                                      'horizontal', (0, 1))
                + pair_records(v_keys, v_shifts, v_conf, 'vertical', (1, 0)),
            }
            self.registration_reports[str(region)] = report

        if self.options.registration_scope == 'global':
            from ..ops.globalopt import (grid_pairs_from_shifts,
                                         positions_to_int, solve_positions)
            h_map = {k: tuple(map(float, s))
                     for k, s in zip(h_keys, h_shifts)}
            v_map = {k: tuple(map(float, s))
                     for k, s in zip(v_keys, v_shifts)}
            h_w = {k: float(c) for k, c in zip(h_keys, h_conf)}
            v_w = {k: float(c) for k, c in zip(v_keys, v_conf)}
            pairs = grid_pairs_from_shifts(
                h_map, v_map, n_rows, n_cols,
                acq.input_width, acq.input_height, ox, oy,
                h_weights=h_w, v_weights=v_w)
            # Sanity clamp: solved positions must stay within the
            # stage/grid-model extent plus slack — one confidently-wrong
            # pair chain must not balloon the canvas. On violation, drop
            # the worst-residual constraint (bounded count) and re-solve
            # — one corrupted pair must not degrade the whole region to
            # the grid model (VERDICT r4 #7); only if the violation
            # survives the drop budget fall back wholesale.
            slack_y, slack_x = 2 * acq.input_height, 2 * acq.input_width

            exp = np.zeros((n_rows * n_cols, 2), np.float64)
            for r_ in range(n_rows):
                for c_ in range(n_cols):
                    ex, ey = geo.tile_position_registered(
                        c_, r_, n_cols, n_rows, acq.input_width,
                        acq.input_height, self.shifts)
                    exp[r_ * n_cols + c_] = (ey, ex)

            def violating_tiles(p, connected):
                """Tiles whose solved position deviates from the grid
                model by more than the slack, modulo the solve's free
                global translation (estimated as the median deviation —
                robust to the flyers being diagnosed). Translation-
                invariant on purpose: solve_positions normalizes by the
                min, so one tile flying NEGATIVE shifts every absolute
                coordinate and an absolute-extent test would blame the
                innocent majority."""
                idx = sorted(connected)
                delta = p[idx].astype(np.float64) - exp[idx]
                t_ = np.median(delta, axis=0)
                dev = np.abs(delta - t_)
                return {idx[k] for k in np.nonzero(
                    (dev[:, 0] > slack_y) | (dev[:, 1] > slack_x))[0]}

            active = list(pairs)
            dropped_pairs = []
            max_drop = max(3, len(pairs) // 10)
            while True:
                pos_f = solve_positions(active, n_rows * n_cols)
                pos = positions_to_int(pos_f)
                # only constrained tiles count: disconnected ones sit at
                # the solver's null position and never reach the canvas
                # (they fall back to the grid model in _build_jobs)
                connected = {i for p_ in active for i in (p_[0], p_[1])}
                bad = violating_tiles(pos, connected) if connected else set()
                if not bad:
                    break
                incident = [k for k, (i, j, *_r) in enumerate(active)
                            if i in bad or j in bad]
                if not incident or len(dropped_pairs) >= max_drop:
                    self.reporter.status(
                        f"global solve for region {region} exceeds the "
                        f"stage extent (+{slack_y}/{slack_x} px slack) even "
                        f"after dropping {len(dropped_pairs)} "
                        "constraint(s); falling back to the grid shift "
                        "model", False)
                    self._global_rejected.add(region)
                    if report is not None:
                        report['global'] = {
                            'rejected': True,
                            'pairs_dropped': [
                                {'i': int(i), 'j': int(j),
                                 'dy': float(dy), 'dx': float(dx)}
                                for i, j, dy, dx, _ in dropped_pairs],
                            'reason': 'solved positions exceed stage extent '
                                      f'(+{slack_y}/{slack_x} px slack) '
                                      f'after {len(dropped_pairs)} drops; '
                                      'grid shift model used instead'}
                    return
                res = np.array([
                    np.hypot(pos_f[j, 0] - pos_f[i, 0] - dy,
                             pos_f[j, 1] - pos_f[i, 1] - dx)
                    for i, j, dy, dx, _ in active])
                if res[incident].max() > 3 * 3.0:
                    # the flying tile's constraints disagree: drop the
                    # single worst — its remaining measurements may
                    # still place it globally
                    drop = [incident[int(res[incident].argmax())]]
                else:
                    # self-consistent corruption (e.g. a coherently-wrong
                    # chain, or a leaf's only edge — residuals near zero):
                    # no measurement can be trusted; disconnect the tile
                    # so IT degrades to the grid model, not the region
                    drop = incident
                if len(dropped_pairs) + len(drop) > max_drop:
                    drop = drop[:max_drop - len(dropped_pairs)]
                for k in sorted(drop, reverse=True):
                    dropped_pairs.append(active.pop(k))
            if dropped_pairs:
                self.reporter.status(
                    f"global solve for region {region}: dropped "
                    f"{len(dropped_pairs)} outlier pair constraint(s) to "
                    "stay within the stage extent", False)
            # only cells with at least one surviving constraint get
            # solved positions; unconstrained tiles (missing file OR all
            # their constraints dropped) fall back to the grid model in
            # _build_jobs
            constrained = {i for p_ in active for i in (p_[0], p_[1])}
            self.global_positions[region] = {
                (r, c): (int(pos[r * n_cols + c, 0]),
                         int(pos[r * n_cols + c, 1]))
                for r in range(n_rows) for c in range(n_cols)
                if r * n_cols + c in constrained}
            self.global_positions_float[region] = {
                (r, c): (float(pos_f[r * n_cols + c, 0]),
                         float(pos_f[r * n_cols + c, 1]))
                for r in range(n_rows) for c in range(n_cols)
                if r * n_cols + c in constrained}
            if report is not None:
                res = np.array([(pos_f[j, 0] - pos_f[i, 0] - dy,
                                 pos_f[j, 1] - pos_f[i, 1] - dx)
                                for i, j, dy, dx, _ in active])
                report['global'] = {
                    'rejected': False,
                    'pairs_dropped': [
                        {'i': int(i), 'j': int(j),
                         'dy': float(dy), 'dx': float(dx)}
                        for i, j, dy, dx, _ in dropped_pairs],
                    'tiles_solved': len(constrained),
                    'tiles_total': n_rows * n_cols,
                    # no pairs (1x1 region, all truncated): no residuals
                    'residual_rms_px': (float(np.sqrt((res ** 2).mean()))
                                        if res.size else None),
                    'residual_max_px': (float(np.abs(res).max())
                                        if res.size else None),
                }

    def _ensure_global_positions(self, t, region: str):
        """Per-region global solve: each region's stage error is its own
        (solved lazily the first time a region is stitched)."""
        if (self.options.registration_scope == 'global'
                and self.params.use_registration
                and region not in self.global_positions
                and region not in self._global_rejected):
            with self.timers.time('registration'):
                self.calculate_shifts_all_pairs(int(t), region)
            m = getattr(self, '_manifest', None)
            if m is not None:
                m.set_global_positions(self.global_positions,
                                       self.global_positions_float)
                m.save()

    # -------------------------------------------------------------- stitching

    def _region_dimensions(self, t, region: str) -> Tuple[int, int]:
        acq = self.acq
        xs, ys = acq.region_positions(int(t), region)
        self._ensure_global_positions(t, region)
        region_pos = self.global_positions.get(region)
        if self.params.use_registration and region_pos:
            ys_px = [p[0] for p in region_pos.values()]
            xs_px = [p[1] for p in region_pos.values()]
            w = max(xs_px) + acq.input_width
            h = max(ys_px) + acq.input_height
            # unconstrained tiles fall back to the grid model; the canvas
            # must cover them too, or backends clamp/truncate differently
            if len(region_pos) < len(xs) * len(ys):
                gw, gh = geo.output_dimensions_registered(
                    len(xs), len(ys), acq.input_width, acq.input_height,
                    self.shifts)
                w, h = max(w, gw), max(h, gh)
        elif self.params.use_registration:
            w, h = geo.output_dimensions_registered(
                len(xs), len(ys), acq.input_width, acq.input_height, self.shifts)
        else:
            w, h = geo.output_dimensions_coordinate(
                xs, ys, acq.input_width, acq.input_height, acq.pixel_size_um)
        if len(acq.regions) > 1:
            rows, cols = acq.rows_and_columns()
            max_dim = max(len(rows), len(cols))
        else:
            max_dim = 1
        self.num_pyramid_levels = geo.num_pyramid_levels(w, h, max_dim)
        return w, h

    def _build_jobs(self, t, region: str) -> List[TileJob]:
        acq = self.acq
        xs, ys = acq.region_positions(int(t), region)
        x_min, y_min = min(xs), min(ys)
        triples = []
        region_pos = self.global_positions.get(region, {})
        for key, rec in acq.region_tiles(int(t), region).items():
            if self.params.use_registration:
                col = xs.index(rec.x)
                row = ys.index(rec.y)
                if (row, col) in region_pos:
                    y_px, x_px = region_pos[(row, col)]
                    pos = (x_px, y_px)
                    if self.options.subpixel_placement:
                        fpos = self.global_positions_float[region][(row, col)]
                        y_px = int(np.floor(fpos[0]))
                        x_px = int(np.floor(fpos[1]))
                        # content shifts by the fractional residual at
                        # load time (io.readers.load_tile_plane)
                        pos = (x_px, y_px, fpos[1] - x_px, fpos[0] - y_px)
                    # per-tile positions express stage jitter; symmetric
                    # median crops would leave unfilled gaps where tiles
                    # diverge — keep full tiles and let overwrite/feather
                    # resolve the (larger) overlaps
                    crops = (0, 0, 0, 0)
                else:
                    pos = geo.tile_position_registered(
                        col, row, len(xs), len(ys),
                        acq.input_width, acq.input_height, self.shifts)
                    crops = geo.tile_crops(col, row, len(xs), len(ys),
                                           self.shifts)
            else:
                pos = geo.tile_position_coordinate(
                    rec.x, rec.y, x_min, y_min, acq.pixel_size_um)
                crops = (0, 0, 0, 0)
            triples.append((rec, pos, crops))
        return expand_tile_jobs(acq.monochrome_channels, acq.rgb_channels, triples)

    def _select_fusion_backend(self) -> str:
        """'host' or 'device' (see :func:`auto_fusion_backend`)."""
        opts = self.options
        if opts.fusion_device != 'auto':
            return opts.fusion_device
        backend = auto_fusion_backend()
        self.reporter.status(f"fusion backend: {backend}", False)
        return backend

    def stitch_region(self, t, region: str):
        """Fuse all tiles of one (timepoint, region) into a canvas.

        Returns the cropped (C, Z, H, W) canvas — a device array when the
        device backend ran, NumPy for the host backend.
        """
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        th, tw = acq.input_height, acq.input_width
        jobs = self._build_jobs(t, region)
        total = len(jobs)
        processed = 0

        if opts.validate_plan:
            from ..utils.plan_check import summarize_plan
            self.reporter.status(summarize_plan(jobs, th, tw), False)

        # An explicit device mesh overrides backend selection: the user
        # asked for sharded multi-chip fusion (overwrite or feather —
        # the banded (acc, wsum) pair shards like the canvas).
        if opts.mesh_shape is not None:
            loader = TileBatchLoader(jobs, opts.fusion_batch, th, tw,
                                     acq.dtype,
                                     num_threads=opts.resolved_reader_threads())
            return self._stitch_region_sharded(loader, height, width, total)

        backend = self._select_fusion_backend()

        if backend == 'host':
            from ..ops.host_fuse import HostCanvas
            ff = self._ff_recip_or_none()
            hc = HostCanvas(acq.num_c, acq.num_z, height, width, acq.dtype,
                            num_threads=opts.resolved_fusion_threads(),
                            ff_recip=ff, blend_method=opts.blend_method,
                            blend_px=opts.feather_px)

            hc.fuse_streaming(
                jobs, load_tile_plane,
                progress_cb=lambda n: self.reporter.update_progress(n, total),
                stop_check=self._check_stop)
            return hc.finalize()

        loader = TileBatchLoader(jobs, opts.fusion_batch, th, tw, acq.dtype,
                                 num_threads=opts.resolved_reader_threads())
        use_feather = opts.blend_method == 'feather'
        pad_shape = fuse_ops.padded_canvas_shape(acq.num_c, acq.num_z,
                                                 height, width, th, tw)
        self._await_ff()
        ff_stack = self._flatfield_recip() if self.flatfields else None

        if use_feather:
            acc = jnp.zeros(pad_shape, jnp.float32)
            wsum = jnp.zeros(pad_shape, jnp.float32)
        else:
            canvas = jnp.zeros(pad_shape, acq.dtype)

        for batch in loader:
            self._check_stop()
            tiles = jnp.asarray(batch.tiles)
            info = jnp.asarray(batch.info)
            crops = jnp.asarray(batch.crops)
            valid = jnp.asarray(batch.valid)
            if ff_stack is not None:
                tiles = fuse_ops.apply_flatfield(tiles, ff_stack, info[:, 0],
                                                 acq.dtype)
            if use_feather:
                acc, wsum = fuse_ops.fuse_feather(
                    acc, wsum, tiles, info, crops, valid,
                    blend_px=opts.feather_px)
            else:
                canvas = fuse_ops.fuse_overwrite(canvas, tiles, info, crops, valid)
            processed += batch.count
            self.reporter.update_progress(processed, total)

        if use_feather:
            canvas = fuse_ops.finalize_feather(acc, wsum, acq.dtype)
        return canvas[:, :, :height, :width]

    def _should_stream(self, t, region: str) -> bool:
        opts = self.options
        # both zarr and TIFF stream band-wise (StreamingTiffWriter
        # interleaves RGB channel bands into SamplesPerPixel=3 pages)
        fmt_ok = self.output_format.endswith(('.zarr', '.tiff'))
        if (opts.streaming == 'off'
                or opts.mesh_shape is not None
                or not fmt_ok):
            return False
        if opts.streaming == 'on':
            return True
        acq = self.acq
        width, height = self._region_dimensions(t, region)
        canvas_bytes = (acq.num_c * acq.num_z * height * width
                        * acq.dtype.itemsize)
        return canvas_bytes > opts.streaming_threshold_bytes

    def _stitch_and_save_streaming(self, t, region: str) -> str:
        """Fuse + write in bounded-memory bands (models/streaming.py).

        The band pipeline has a host twin (threaded NumPy + native C)
        and a device twin (device-resident bands through the jitted
        fusion kernels); selection follows the same fusion_device rule
        as the in-RAM paths.
        """
        from .streaming import DeviceStreamingFuser, StreamingFuser
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        jobs = self._build_jobs(t, region)
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        if self.output_format.endswith('.tiff'):
            from ..io.ometiff import region_position_um, tiff_rgb_mode
            from ..io.tiffwriter import StreamingTiffWriter
            writer = StreamingTiffWriter(
                output_path, (1, acq.num_c, acq.num_z, height, width),
                self.num_pyramid_levels, acq.dtype,
                f"{region}_t{t}", acq.dz_um, acq.pixel_size_um,
                acq.monochrome_channels, acq.monochrome_colors,
                position_um=region_position_um(acq, t, region),
                rgb=tiff_rgb_mode(acq),
                compression=opts.tiff_compression,
                jpeg_quality=opts.tiff_jpeg_quality)
        else:
            writer = MultiscaleWriter(
                output_path, (1, acq.num_c, acq.num_z, height, width),
                self.num_pyramid_levels, acq.dtype, opts.chunks,
                f"{region}_t{t}", acq.dz_um, acq.pixel_size_um,
                acq.monochrome_channels, acq.monochrome_colors,
                cname=(cc := self.resolved_compressor())[0], clevel=cc[1],
                shuffle=cc[2], zarr_format=opts.zarr_format,
                direct_io=opts.direct_io)
        backend = self._select_fusion_backend()
        # host streaming may start before the overlapped fit finishes:
        # each band parks on its channel's gate instead of the whole run
        # parking on the last channel's solve
        gate = self._ff_gate if self._ff_future is not None else None
        ff = None if gate is not None else self._ff_recip_or_none()
        if backend == 'device':
            ff = self._ff_recip_or_none()  # device upload needs all fields
            gate = None
            fuser = DeviceStreamingFuser(
                writer, acq.num_c, acq.num_z, height, width,
                acq.input_height, acq.input_width, acq.dtype,
                self.num_pyramid_levels, opts.pyramid_downsample,
                chunk_rows=opts.write_band_rows()
                * opts.device_band_multiple,
                batch_size=opts.fusion_batch,
                reader_threads=opts.resolved_reader_threads(),
                ff_recip=ff, blend_method=opts.blend_method,
                blend_px=opts.feather_px)
        else:
            fuser = StreamingFuser(
                writer, acq.num_c, acq.num_z, height, width,
                acq.input_height, acq.input_width, acq.dtype,
                self.num_pyramid_levels, opts.pyramid_downsample,
                chunk_rows=opts.write_band_rows(),
                num_threads=opts.resolved_fusion_threads(),
                ff_recip=ff, blend_method=opts.blend_method,
                blend_px=opts.feather_px, ff_gate=gate)

        fuser.run(jobs, load_tile_plane,
                  progress_cb=self.reporter.update_progress,
                  stop_check=self._check_stop)
        if hasattr(fuser, 'stats'):
            self.reporter.status(
                "stream stages: " + " ".join(
                    f"{k}={v:.2f}s" for k, v in fuser.stats.items()), False)
        if getattr(fuser, 'cpu', None):
            # on-core per-stage sums: the CPU-floor decomposition (wall
            # sums above bill contention/IO to whatever stage held the
            # thread; see StreamingFuser.cpu)
            self.reporter.status(
                "stream cpu: " + " ".join(
                    f"{k}={v:.2f}s" for k, v in fuser.cpu.items()), False)
        return output_path

    def _stitch_region_sharded(self, loader, height: int, width: int,
                               total: int):
        """Multi-chip fusion: canvas Y-banded over the mesh 'canvas' axis
        (parallel/sharded_fuse), tiles replicated per batch."""
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_fuse import ShardedCanvas
        acq = self.acq
        opts = self.options
        mesh = make_mesh(opts.mesh_shape)
        ff_np = self._ff_recip_or_none()
        canvas = ShardedCanvas(mesh, acq.num_c, acq.num_z, height, width,
                               acq.input_height, acq.input_width, acq.dtype,
                               blend_method=opts.blend_method,
                               blend_px=opts.feather_px,
                               ff_recip=ff_np)
        # ShardedCanvas owns the correction (batched apply_flatfield)
        processed = 0
        for batch in loader:
            self._check_stop()
            tiles = jnp.asarray(batch.tiles)
            info = jnp.asarray(batch.info)
            canvas.fuse_batch(tiles, info, jnp.asarray(batch.crops),
                              jnp.asarray(batch.valid))
            processed += batch.count
            self.reporter.update_progress(processed, total)
        return canvas.finalize()

    # ------------------------------------------------------------------ save

    def save_region(self, t, region: str, canvas: jnp.ndarray,
                    num_levels: Optional[int] = None) -> str:
        """Write the multiscale OME-Zarr for one region/timepoint.

        ``num_levels`` is passed explicitly by the pipelined-save path so
        a background save is immune to the next region recomputing
        ``self.num_pyramid_levels``.
        """
        acq = self.acq
        opts = self.options
        if num_levels is None:
            num_levels = self.num_pyramid_levels
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)

        if not self.output_format.endswith('.zarr'):
            from ..io.ometiff import write_ome_tiff_region
            return write_ome_tiff_region(self, t, region, canvas, output_path,
                                         num_levels=num_levels)

        c, z, h, w = canvas.shape
        writer = MultiscaleWriter(
            output_path, (1, c, z, h, w), num_levels,
            acq.dtype, opts.chunks, f"{region}_t{t}", acq.dz_um,
            acq.pixel_size_um, acq.monochrome_channels, acq.monochrome_colors,
            cname=(cc := self.resolved_compressor())[0], clevel=cc[1],
            shuffle=cc[2], zarr_format=opts.zarr_format,
            direct_io=opts.direct_io)
        for lv, level in enumerate(pyr_ops.iter_levels(
                canvas, num_levels, opts.pyramid_downsample)):
            writer.write_level(lv, np.asarray(level)[None])
        writer.close()
        return output_path

    # ------------------------------------------------------------------- run

    def _process_regions(self, manifest) -> Optional[str]:
        """Fuse and save every (timepoint, region), optionally pipelined:
        region N saves on a bounded background writer while region N+1
        fuses (single in-flight canvas caps memory)."""
        from concurrent.futures import ThreadPoolExecutor

        final_path: Optional[str] = None
        pending = None  # (future, timepoint, region)
        executor = (ThreadPoolExecutor(max_workers=1)
                    if self.options.pipelined_save else None)

        def do_save(timepoint, region, canvas, num_levels):
            with self.timers.time('save'):
                return self.save_region(timepoint, region, canvas,
                                        num_levels=num_levels)

        def reap(entry):
            nonlocal final_path
            future, timepoint, region = entry
            try:
                path = future.result() if hasattr(future, 'result') else future
            except Exception as e:
                if not self.options.continue_on_error:
                    raise
                self.reporter.error(f"region {region} t{timepoint} failed: {e}")
                return
            final_path = path
            self.saved_paths.append(path)
            manifest.mark_completed(timepoint, region)
            self.reporter.status(f"Completed region {region} t{timepoint}",
                                 False)

        shard = self.options.work_shard
        unit_idx = -1
        try:
            for timepoint in self.acq.timepoints:
                timepoint = int(timepoint)
                os.makedirs(os.path.join(self.output_folder,
                                         f"{timepoint}_stitched"),
                            exist_ok=True)
                for region in self.acq.regions:
                    self._check_stop()
                    unit_idx += 1
                    if shard is not None and unit_idx % shard[1] != shard[0]:
                        # another shard owns this unit (deterministic
                        # round-robin over the (t, region) enumeration)
                        continue
                    if manifest.is_completed(timepoint, region):
                        final_path = (self.per_timepoint_region_output_template
                                      .format(timepoint=timepoint,
                                              region=region))
                        self.reporter.status(
                            f"Skipping completed region {region} "
                            f"t{timepoint}", False)
                        continue
                    self.reporter.starting_stitching()
                    if self._should_stream(timepoint, region):
                        try:
                            with self.timers.time('stream_fuse_save'):
                                path = self._stitch_and_save_streaming(
                                    timepoint, region)
                        except StitchCancelled:
                            raise
                        except Exception as e:
                            if not self.options.continue_on_error:
                                raise
                            self.reporter.error(
                                f"region {region} t{timepoint} failed: {e}")
                            continue
                        reap((path, timepoint, region))
                        continue
                    try:
                        with self.timers.time('fuse'):
                            canvas = self.stitch_region(timepoint, region)
                    except StitchCancelled:
                        raise
                    except Exception as e:
                        if not self.options.continue_on_error:
                            raise
                        self.reporter.error(
                            f"region {region} t{timepoint} failed: {e}")
                        continue
                    self.reporter.starting_saving(False)
                    levels_now = self.num_pyramid_levels
                    if executor is not None:
                        if pending is not None:
                            reap(pending)  # bound in-flight canvases to 1
                        pending = (executor.submit(do_save, timepoint,
                                                   region, canvas,
                                                   levels_now),
                                   timepoint, region)
                    else:
                        try:
                            path = do_save(timepoint, region, canvas,
                                           levels_now)
                        except StitchCancelled:
                            raise
                        except Exception as e:
                            if not self.options.continue_on_error:
                                raise
                            self.reporter.error(
                                f"region {region} t{timepoint} failed: {e}")
                            continue
                        reap((path, timepoint, region))
            if pending is not None:
                reap(pending)
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        return final_path

    def _write_registration_report(self) -> None:
        """Dump per-region pairwise measurements + solve stats to
        ``registration_report.json`` in the output folder (atomic;
        shard-suffixed under work sharding so cooperating processes
        never clobber each other)."""
        if not (self.options.registration_report
                and self.registration_reports):
            return
        import json
        shard = self.options.work_shard
        name = ("registration_report"
                + (f".shard{shard[0]}" if shard is not None else "")
                + ".json")
        path = os.path.join(self.output_folder, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"registration_channel": self.registration_channel,
                       "upsample_factor": self.options.upsample_factor,
                       "regions": self.registration_reports}, f, indent=2)
        os.replace(tmp, path)
        self.reporter.status(f"Registration report: {path}", False)

    def run(self) -> str:
        """Execute the full pipeline; returns the last saved path."""
        from ..utils.manifest import RunManifest
        t0 = time.time()
        try:
            with self.timers.time('scan'):
                self.acq = scan_acquisition(self.input_folder)
            os.makedirs(self.output_folder, exist_ok=True)

            shard = self.options.work_shard
            suffix = f".shard{shard[0]}" if shard is not None else ""
            manifest = (RunManifest.load(self.output_folder, suffix=suffix)
                        if self.resumed else None) \
                or RunManifest(self.output_folder, suffix=suffix)
            manifest.set_params(self.params.to_dict(),
                                self.options.output_fingerprint())

            # The flatfield fit and the registration measurement read
            # disjoint data (decimated samples vs overlap strips) and
            # share no state: overlap them — the sum is pure serial
            # latency otherwise.
            ff_future = None
            if self.params.apply_flatfield:
                if self.resumed:
                    self.flatfields = manifest.load_flatfields()
                if not self.flatfields:
                    if self.options.overlap_prep:
                        # overlapped fit with a per-channel gate: the fit
                        # runs concurrently with registration (disjoint
                        # data) AND with fusion — the streaming fuser
                        # starts channel c the moment channel c's fit
                        # publishes, instead of parking the whole run
                        # behind the last channel's solve.
                        from .streaming import FlatfieldGate
                        gate = FlatfieldGate(
                            self.acq.num_c,
                            (self.acq.input_height, self.acq.input_width))
                        self._ff_gate = gate

                        def _fit_flatfields():
                            _deprioritize_thread()
                            try:
                                with self.timers.time('flatfield_fit'):
                                    self.compute_flatfields()
                            except BaseException as e:
                                gate.fail(e)
                                raise
                            else:
                                gate.finish()
                                # persist from the fit thread (atomic
                                # rename) so a crash mid-fusion still
                                # resumes without refitting
                                manifest.save_flatfields(self.flatfields)
                        # pre-import the heavy module both stages load
                        # lazily: a concurrent FIRST import of scipy from
                        # two threads can observe a partially
                        # initialized module and crash
                        from scipy import fft as _scipy_fft  # noqa: F401
                        from concurrent.futures import ThreadPoolExecutor
                        _prep_pool = ThreadPoolExecutor(1)
                        ff_future = _prep_pool.submit(_fit_flatfields)
                        _prep_pool.shutdown(wait=False)
                        self._ff_future = ff_future
                    else:
                        with self.timers.time('flatfield_fit'):
                            self.compute_flatfields()
                        manifest.save_flatfields(self.flatfields)

            try:
                if self.params.use_registration:
                    saved_shifts = (manifest.get_shifts()
                                    if self.resumed else None)
                    if saved_shifts is not None:
                        self.shifts = saved_shifts
                        (self.global_positions,
                         self.global_positions_float) = \
                            manifest.get_global_positions()
                    if saved_shifts is None or (
                            self.options.registration_scope == 'global'
                            and not self.global_positions):
                        with self.timers.time('registration'):
                            if self.options.registration_scope in (
                                    'all-pairs', 'global'):
                                self.calculate_shifts_all_pairs(
                                    int(self.acq.timepoints[0]),
                                    self.acq.regions[0])
                            else:
                                self.calculate_shifts(
                                    self.acq.timepoints[0],
                                    self.acq.regions[0])
                    manifest.set_shifts(self.shifts)
                    if self.global_positions:
                        manifest.set_global_positions(
                            self.global_positions,
                            self.global_positions_float)
            except BaseException:
                # registration failed/cancelled: reap the overlapped fit
                # so its thread never outlives the run (or leaks its
                # error); the registration failure is the one reported.
                # Only the FIT's own Exception is swallowed — a
                # KeyboardInterrupt raised in THIS thread during the
                # wait must still win.
                if ff_future is not None:
                    try:
                        ff_future.result()
                    except Exception:
                        pass
                raise
            manifest.save()
            self._manifest = manifest

            # NOT waiting on ff_future here: regions fusing through the
            # host streaming path ride the per-channel gate; every other
            # consumer reaches the fields via _await_ff (below), which
            # surfaces fit errors and persists the fits exactly once.
            final_path = self._process_regions(manifest) or ''
            self._await_ff()

            do_merge = (self.params.merge_timepoints
                        or self.params.merge_hcs_regions)
            if do_merge and shard is not None:
                # merges read every shard's region outputs: all
                # processes must reach this point first (collective;
                # no-op when jax isn't multi-process)
                self._shard_barrier()
            if do_merge and shard is not None and shard[0] != 0:
                self.reporter.status(
                    "merges are the coordinator shard's job; skipping on "
                    f"shard {shard[0]}", False)
            elif self.params.merge_timepoints or self.params.merge_hcs_regions:
                if self.resumed and manifest.data.get("merges_done"):
                    self.reporter.status("Merges already complete; skipping",
                                         False)
                else:
                    from .merge import run_merges
                    self.reporter.starting_saving(True)
                    # a fully-resumed run may have skipped every region;
                    # recompute the pyramid depth the merges must use
                    self._region_dimensions(int(self.acq.timepoints[0]),
                                            self.acq.regions[0])
                    with self.timers.time('merge'):
                        final_path = run_merges(self)
                    manifest.data["merges_done"] = True
                    manifest.save()

            self._write_registration_report()
            manifest.mark_finished()
            self.reporter.finished_saving(final_path, self.acq.dtype)
            for line in self.timers.summary():
                self.reporter.status(line, False)
            self.reporter.status(
                f"Total processing time: {time.time() - t0:.1f}s", False)
            return final_path
        except StitchCancelled:
            self.reporter.status("Stitching cancelled", False)
            raise
        except Exception as e:
            self.reporter.error(str(e))
            raise
