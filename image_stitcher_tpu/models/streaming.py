"""Streaming fusion: tiles -> zarr store with bounded memory.

The reference's zarr_stitcher never materializes the canvas — workers
write FOVs straight into the store (zarr_stitcher.py:421-489) and the
pyramid is built level-from-level in z-blocks (:614-664). This module is
that architecture done band-wise: each (channel, z) plane is fused in
horizontal bands sized to the chunk grid; a finished band is written to
level 0 and immediately downsampled into every pyramid level (band rows
are a multiple of 2^(levels-1), so pooling windows never cross bands).
Peak memory = bands-in-flight x band bytes, independent of canvas size.

Tiles spanning a band boundary are re-read per band (reads are cheap via
the fast TIFF path); within a band, jobs apply in global plan order, so
overwrite semantics match the in-RAM paths exactly (tested).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.omezarr import MultiscaleWriter
from ..ops.host_fuse import correct_tile, host_downsample, place_window_native


def band_rows_for(chunk_rows: int, num_levels: int) -> int:
    """Band height: >= one chunk row, multiple of 2^(num_levels-1)."""
    align = 1 << max(0, num_levels - 1)
    return max(chunk_rows, ((chunk_rows + align - 1) // align) * align)


def write_band_levels(writer: MultiscaleWriter, c: int, z: int, band0: int,
                      buf: np.ndarray, num_levels: int, mode: str,
                      width: int, tick: Optional[Callable] = None,
                      first_level: int = 0) -> bool:
    """Write one finished (c, z) band to level ``first_level`` and fold
    it into every deeper pyramid level (band rows are a multiple of
    2^(levels-1), so pooling windows never cross bands). Shared by the
    host and device streaming fusers — and, with ``first_level=1``, by
    the block-banding path, whose level-0 chunks land separately;
    ``band0`` is always in LEVEL-0 rows. ``tick(stage, t0)`` hooks the
    host fuser's stage stats.

    Returns True when the writer consumed ``buf`` before returning
    (synchronous raw path) — the caller may then reuse the band buffer;
    deeper-level slabs are freshly allocated per call either way."""
    import time as _time
    t0 = _time.perf_counter()
    released = None
    level = buf
    for lv in range(first_level, num_levels):
        if lv > first_level:
            level = host_downsample(level, mode)
            if tick:
                t0 = tick('pyramid', t0)
        h_lv, w_lv = level.shape
        if h_lv == 0 or w_lv == 0:
            break
        b_lv = band0 >> lv
        sel = (slice(0, 1), slice(c, c + 1), slice(z, z + 1),
               slice(b_lv, b_lv + h_lv), slice(0, w_lv))
        r = writer.write_level(lv, level[None, None, None], sel=sel)
        if lv == first_level:
            released = r
        if tick:
            t0 = tick('write', t0)
    return released is True


def partition_jobs_by_band(jobs: Sequence, tile_h: int, height: int,
                           band: int):
    """Group jobs by (channel, z, band_start), preserving plan order
    within each band. A job appears in every band its cropped window
    intersects; ``is_primary`` is True only for its first band so
    progress counts each job exactly once.

    Returns (tasks dict, n_jobs).
    """
    tasks: Dict[Tuple[int, int, int], List] = {}
    n_jobs = 0
    for job in jobs:
        top, bottom = job.crops[0], job.crops[1]
        y0e = job.y + top
        y1e = min(job.y + tile_h - bottom, height)
        if y1e <= y0e:
            continue
        n_jobs += 1
        first = True
        for b in range(y0e // band, (y1e - 1) // band + 1):
            tasks.setdefault((job.channel_idx, job.z_level,
                              b * band), []).append((job, first))
            first = False
    return tasks, n_jobs


class FlatfieldGate:
    """Per-channel flatfield readiness gate.

    The ADMM fit runs per channel; fusion of channel c only needs
    channel c's field. Publishing each fit as it lands lets the band
    fusers start streaming while later channels are still solving —
    on the serial reference flow the whole fit is dead time before the
    first tile is placed (stitcher.py:374-394 fits every channel up
    front). ``recip`` is the shared (C, th, tw) reciprocal stack; row c
    is immutable once its event is set, so readers gated on ``wait(c)``
    never observe a partial row.
    """

    def __init__(self, num_c: int, tile_hw: Tuple[int, int]):
        import threading
        self.recip = np.ones((num_c,) + tuple(tile_hw), np.float32)
        self._events = [threading.Event() for _ in range(num_c)]
        self._error: Optional[BaseException] = None

    def publish(self, c: int, field: Optional[np.ndarray]) -> None:
        """Record channel ``c``'s fitted field (None keeps identity)."""
        if field is not None:
            np.divide(1.0, field, out=self.recip[c])
        self._events[c].set()

    def finish(self) -> None:
        """All fits done: release channels that never got a field."""
        for e in self._events:
            e.set()

    def fail(self, exc: BaseException) -> None:
        """Unblock every waiter with the fit's error (re-raised there,
        preserving the type so cancellation classification survives)."""
        self._error = exc
        for e in self._events:
            e.set()

    def wait(self, c: int) -> np.ndarray:
        self._events[c].wait()
        if self._error is not None:
            raise self._error
        return self.recip


class StreamingFuser:
    """Fuse per-plane bands and stream them into a MultiscaleWriter."""

    def __init__(self, writer: MultiscaleWriter, num_c: int, num_z: int,
                 height: int, width: int, tile_h: int, tile_w: int, dtype,
                 num_levels: int, downsample_mode: str = 'nearest',
                 chunk_rows: int = 2048, num_threads: int = 2,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 ff_gate: Optional[FlatfieldGate] = None,
                 pad_width_to: int = 0):
        self.writer = writer
        self.num_c, self.num_z = num_c, num_z
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.num_levels = num_levels
        self.mode = downsample_mode
        self.band = band_rows_for(chunk_rows, num_levels)
        self.num_threads = num_threads
        self.ff_recip = ff_recip
        self.ff_gate = ff_gate
        self.blend = blend_method
        self.blend_px = blend_px
        # per-stage wall-clock accumulators (summed across band threads)
        self.stats = {'decode': 0.0, 'place': 0.0, 'finalize': 0.0,
                      'pyramid': 0.0, 'write': 0.0, 'close': 0.0}
        # per-stage ON-CORE time (thread_time sums): on a contended host
        # the wall sums above bill scheduler starvation and IO blocks to
        # whatever stage was running; these are the numbers that bound a
        # full-core run (the e2e CPU floor decomposition)
        self.cpu: Dict[str, float] = {}
        import threading as _threading
        self._stats_lock = _threading.Lock()
        # per-thread band buffer pool: fresh np.zeros per band costs a
        # first-touch page fault per 4 KiB (GBs of kernel zeroing per
        # run); a reused hot buffer + explicit fill(0) doesn't. Reuse is
        # only legal while the writer consumes slabs synchronously
        # (write_band_levels reports it), so an async fallback drops the
        # thread's buffer and reverts to fresh allocation.
        self._tl = _threading.local()
        # optional width-pad of the pool to the chunk grid: with a
        # page-aligned buffer and a 4096-multiple row pitch, every full
        # chunk column's rows are O_DIRECT-aligned in place. Kept as a
        # mechanism (tested) but NOT requested by the pipeline: a
        # gather-pwritev from the strided source measured 15-20% slower
        # than the staging pack on the bench device (see
        # raw_zarr._pwrite_rows), so padding currently buys nothing.
        # Tiles never touch the pad columns (x is clamped to ``width``)
        # and fill(0) keeps them zero.
        self.alloc_width = (-(-width // pad_width_to) * pad_width_to
                            if pad_width_to > 0 else width)
        # chunk-column block mode: the band lives as (ncx, band, cx)
        # chunk-shaped blocks, so every level-0 chunk file is ONE
        # contiguous pwrite straight from the pool — no row gather, no
        # staging pack (measured: the row path's O_DIRECT staging pack
        # is the write stage's main CPU). Only for overwrite blending on
        # writers that expose chunk-contiguous block writes (raw v2).
        # flips False on the first loaded tile whose shape contradicts
        # the nominal dims — the band fill-skip's coverage proofs rest
        # on them (see _band_covered)
        self._nominal_dims_ok = True
        self._block_cx = 0
        if blend_method == 'overwrite':
            spec = getattr(writer, 'block_spec', None)
            bs = spec(0) if spec is not None else None
            # chunk width must be EVEN: pyramid level 1 is assembled
            # from per-block downsamples, whose 2-column windows must
            # never straddle a block boundary (byte parity with the
            # row-major band)
            if (bs and bs[0] > 0 and self.band % bs[0] == 0
                    and bs[1] % 2 == 0):
                self._block_cx = int(bs[1])

    def _tick(self, key: str, t0: float) -> float:
        import time as _time
        t1 = _time.perf_counter()
        c1 = _time.thread_time()
        # cpu0 tracks the calling thread's last tick (or segment start
        # via _cpu_mark); chained ticks segment CPU exactly like wall
        c0 = getattr(self._tl, 'cpu0', c1)
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0.0) + (t1 - t0)
            self.cpu[key] = self.cpu.get(key, 0.0) + (c1 - c0)
        self._tl.cpu0 = c1
        return t1

    def _cpu_mark(self) -> None:
        """Start a CPU segment on this thread (wall segments start by
        reading perf_counter; CPU segments must reset the thread-local
        base too, or the first tick after an un-ticked gap — gate waits,
        pool scheduling — absorbs that gap's on-core time)."""
        import time as _time
        self._tl.cpu0 = _time.thread_time()

    # ------------------------------------------------------------------

    def _correct(self, tile: np.ndarray, c: int) -> np.ndarray:
        return correct_tile(tile, self.ff_recip, c, self.dtype)

    def _place_in_band(self, buf: np.ndarray, band0: int, job,
                       tile: np.ndarray) -> None:
        top, bottom, left, right = job.crops
        th, tw = tile.shape
        # full crop window in TILE coordinates, from the actual loaded
        # shape (matching HostCanvas._place; feather ramps measure from
        # these edges), then canvas + band clamping of the visible part
        wy1 = th - bottom if bottom else th
        wx1 = tw - right if right else tw
        y0, y1 = top, wy1
        x0, x1 = left, wx1
        yy, xx = job.y + top, job.x + left
        y1 = min(y1, y0 + (self.height - yy))
        x1 = min(x1, x0 + (self.width - xx))
        blocked = not isinstance(buf, tuple) and buf.ndim == 3
        n_rows = (buf[0].shape[0] if isinstance(buf, tuple)
                  else buf.shape[1] if blocked else buf.shape[0])
        b_lo, b_hi = band0, band0 + n_rows
        if yy < b_lo:
            y0 += b_lo - yy
            yy = b_lo
        y1 = min(y1, y0 + (b_hi - yy))
        if y1 <= y0 or x1 <= x0:
            return
        c = job.channel_idx
        ff_c = self.ff_recip[c] if self.ff_recip is not None else None
        if blocked:
            # chunk-column block layout: split the window at chunk
            # boundaries (a tile touches at most ceil(tw/cx)+1 blocks)
            # and place each segment into its block
            cx = self._block_cx
            native_ok = self.dtype == tile.dtype
            t = None
            for cxi in range(xx // cx, (xx + (x1 - x0) - 1) // cx + 1):
                gx0 = max(xx, cxi * cx)
                gx1 = min(xx + (x1 - x0), (cxi + 1) * cx)
                tx0 = x0 + (gx0 - xx)
                tx1 = tx0 + (gx1 - gx0)
                dx = gx0 - cxi * cx
                if native_ok and place_window_native(
                        buf[cxi], tile, ff_c, y0, y1, tx0, tx1,
                        yy - band0, dx):
                    continue
                if t is None:
                    t = self._correct(tile, c)
                buf[cxi][yy - band0:yy - band0 + (y1 - y0),
                         dx:dx + (tx1 - tx0)] = t[y0:y1, tx0:tx1]
            return
        feather = ((top, wy1, left, wx1, 1.0 / float(self.blend_px))
                   if self.blend == 'feather' else None)
        if self.dtype == tile.dtype and place_window_native(
                buf, tile, ff_c, y0, y1, x0, x1, yy - band0, xx,
                feather=feather):
            return
        t = self._correct(tile, c)[y0:y1, x0:x1]
        if self.blend == 'feather':
            acc, wsum = buf
            dy = np.minimum(np.arange(y0, y1) - top + 1,
                            wy1 - np.arange(y0, y1))
            dx = np.minimum(np.arange(x0, x1) - left + 1,
                            wx1 - np.arange(x0, x1))
            wgt = (np.minimum.outer(dy, dx).astype(np.float32)
                   / self.blend_px).clip(0, 1)
            acc[yy - band0:yy - band0 + t.shape[0],
                xx:xx + t.shape[1]] += wgt * t.astype(np.float32)
            wsum[yy - band0:yy - band0 + t.shape[0],
                 xx:xx + t.shape[1]] += wgt
        else:
            buf[yy - band0:yy - band0 + t.shape[0], xx:xx + t.shape[1]] = t

    def _band_covered(self, jobs: Sequence, band0: int, rows: int) -> bool:
        """True iff the jobs' nominal visible rects tile the whole band.

        Overwrite mode then skips the band's zero fill — the pooled
        buffer's previous contents are fully overwritten anyway, and
        the fill is real CPU (band rows x canvas width x itemsize per
        band per channel: ~2.3 GB of memset per g10 bench run, the
        band pool's last avoidable pass). Rects use the NOMINAL tile
        dims; `_process_band` verifies each loaded tile against them
        and falls back to a zeroed replay on mismatch, so correctness
        never rests on this estimate.

        Union test: y-sweep over slab boundaries; every slab's
        x-interval union must span [0, width). O(jobs^2) worst case on
        a few dozen rects — noise next to one tile decode."""
        if not self._nominal_dims_ok:
            # a loaded tile already contradicted the nominal dims: every
            # further coverage proof would fail the same way, and each
            # failed proof costs a full band re-decode (replay). Fill.
            return False
        th, tw = self.tile_h, self.tile_w
        b_lo, b_hi = band0, band0 + rows
        rects = []
        for job, _ in jobs:
            top, bottom, left, right = job.crops
            y0 = max(job.y + top, b_lo)
            y1 = min(job.y + (th - bottom if bottom else th),
                     self.height, b_hi)
            x0 = job.x + left
            x1 = min(job.x + (tw - right if right else tw), self.width)
            if y1 > y0 and x1 > x0 and y0 >= 0 and x0 >= 0:
                rects.append((y0, y1, x0, x1))
        if not rects:
            return rows <= 0
        rects.sort(key=lambda r: r[2])  # the sweep scans x0-ascending
        ys = sorted({v for r in rects for v in r[:2]} | {b_lo, b_hi})
        for ya, yb in zip(ys, ys[1:]):
            if yb <= b_lo or ya >= b_hi:
                continue
            reach = 0
            for y0, y1, x0, x1 in rects:
                # intervals pre-sorted by x0 via rect sort below
                if y0 <= ya and y1 >= yb:
                    if x0 > reach:
                        return False
                    reach = max(reach, x1)
            if reach < self.width:
                return False
        return True

    def _process_band(self, c: int, z: int, band0: int,
                      jobs: Sequence, load_fn: Callable,
                      progress_cb=None, stop_check=None) -> None:
        import time as _time
        if self.ff_gate is not None:
            # block this band until channel c's fit lands; the overlapped
            # fit publishes channels in order, so only the first bands of
            # later channels ever park here
            self.ff_recip = self.ff_gate.wait(c)
        rows = min(self.band, self.height - band0)
        t0 = _time.perf_counter()
        self._cpu_mark()  # band buffer prep (pool alloc + zero fill)
        if self.blend == 'feather':
            # acc/wsum never reach the writer (finalize produces a fresh
            # cast) — always reusable
            pair = getattr(self._tl, 'feather', None)
            if pair is None:
                pair = (np.empty((self.band, self.width), np.float32),
                        np.empty((self.band, self.width), np.float32))
                self._tl.feather = pair
            buf = (pair[0][:rows], pair[1][:rows])
            buf[0].fill(0.0)
            buf[1].fill(0.0)
        elif self._block_cx:
            buf = getattr(self._tl, 'blocks', None)
            if buf is None or buf.dtype != self.dtype:
                import mmap as _mmap
                cx = self._block_cx
                ncx = -(-self.width // cx)
                n_elems = ncx * self.band * cx
                mm = _mmap.mmap(-1, max(n_elems * self.dtype.itemsize,
                                        _mmap.PAGESIZE))
                buf = np.frombuffer(mm, self.dtype, count=n_elems
                                    ).reshape(ncx, self.band, cx)
                self._tl.blocks = buf
            buf = buf[:, :rows]
            if self._band_covered(jobs, band0, rows):
                # fully-overwritten band: skip the memset, but the last
                # block's padded tail columns (>= width) DO land in the
                # level-0 chunk file and must stay fill-value zero
                ncx, _, cx = buf.shape
                tail0 = self.width - (ncx - 1) * cx
                if tail0 < cx:
                    buf[-1][:, tail0:] = 0
                filled = False
            else:
                buf.fill(0)
                filled = True
        else:
            buf = getattr(self._tl, 'band', None)
            if buf is None or buf.dtype != self.dtype:
                # anonymous mmap => page-aligned base (any future
                # direct-IO-from-band path needs it; np.empty won't do)
                import mmap as _mmap
                n_elems = self.band * self.alloc_width
                mm = _mmap.mmap(-1, max(n_elems * self.dtype.itemsize,
                                        _mmap.PAGESIZE))
                buf = np.frombuffer(mm, self.dtype, count=n_elems
                                    ).reshape(self.band, self.alloc_width)
                self._tl.band = buf
            buf = buf[:rows]
            if self._band_covered(jobs, band0, rows):
                # writers only see buf[:, :width]; the pad columns
                # (pad_width_to in-place O_DIRECT layouts) still promise
                # zeros past width — keep that invariant cheaply
                if buf.shape[1] > self.width:
                    buf[:, self.width:] = 0
                filled = False
            else:
                buf.fill(0)
                filled = True
        if self.blend == 'feather':
            filled = True  # accumulators above start from zero
        self._tick('fill', t0)
        nominal = (self.tile_h, self.tile_w)
        reported = -1  # highest job index whose progress already fired
        i = 0
        while i < len(jobs):
            job, is_primary = jobs[i]
            if stop_check is not None:
                stop_check()  # per-tile cancellation, like HostCanvas
            t0 = _time.perf_counter()
            tile = load_fn(job)
            t0 = self._tick('decode', t0)
            if not filled and tile.shape[-2:] != nominal:
                # a tile smaller than its nominal rect breaks the
                # coverage proof the fill skip rested on: zero the band
                # and REPLAY placements (progress below never re-fires).
                # Remember instance-wide so later bands fill up front
                # instead of each paying a full re-decode.
                self._nominal_dims_ok = False
                buf.fill(0)
                filled = True
                i = 0
                continue
            self._place_in_band(buf, band0, job, tile)
            self._tick('place', t0)
            if progress_cb is not None and is_primary and i > reported:
                reported = i
                progress_cb()
            i += 1
        t0 = _time.perf_counter()
        if not isinstance(buf, tuple) and buf.ndim == 3:
            self._tick('finalize', t0)
            if not self._write_blocks(c, z, band0, buf):
                self._tl.blocks = None
            return
        if self.blend == 'feather':
            from ..ops.host_fuse import finalize_feather_host
            acc, wsum = buf
            buf = finalize_feather_host(acc, wsum, self.dtype)
        elif buf.shape[1] != self.width:
            # the writer sees the canvas-width view of the padded pool
            buf = buf[:, :self.width]
        self._tick('finalize', t0)
        released = write_band_levels(self.writer, c, z, band0, buf,
                                     self.num_levels, self.mode, self.width,
                                     tick=self._tick)
        if not released and self.blend != 'feather':
            # async writer (tensorstore fallback / TIFF row streams)
            # still references the overwrite-path buffer: orphan it and
            # let the next band allocate fresh. Feather buffers never
            # reach the writer (finalize casts into a new array).
            self._tl.band = None

    def _write_blocks(self, c: int, z: int, band0: int,
                      blocks: np.ndarray) -> bool:
        """Block-mode band output: level 0 lands chunk-by-chunk straight
        from the pool (one contiguous pwrite each); pyramid levels are
        assembled from per-block downsamples (chunk widths are even, so
        2x2 pooling windows never straddle blocks — byte-identical to
        downsampling the row-major band, tested).

        Returns False when any write retained a view of the pool (the
        caller then orphans it)."""
        import time as _time
        ncx = blocks.shape[0]
        released = True
        t0 = _time.perf_counter()
        for cxi in range(ncx):
            ok = self.writer.write_level_block(0, c, z, band0, cxi,
                                               blocks[cxi])
            released = released and bool(ok)
        t0 = self._tick('write', t0)
        if self.num_levels <= 1:
            return released
        rows = blocks.shape[1]
        w1, h1 = self.width // 2, rows // 2
        if h1 == 0 or w1 == 0:
            return released
        cw1 = blocks.shape[2] // 2
        level1 = np.empty((h1, ncx * cw1), self.dtype)
        for i in range(ncx):
            # strided out= column: native kernel writes its dst stride,
            # so no per-block copy + no concatenate pass
            host_downsample(blocks[i], self.mode,
                            out=level1[:, i * cw1:(i + 1) * cw1])
        level1 = level1[:, :w1]
        self._tick('pyramid', t0)
        write_band_levels(self.writer, c, z, band0, level1,
                          self.num_levels, self.mode, self.width,
                          tick=self._tick, first_level=1)
        return released

    # ------------------------------------------------------------------

    def run(self, jobs: Sequence, load_fn: Callable,
            progress_cb: Optional[Callable[[int], None]] = None,
            stop_check: Optional[Callable] = None) -> None:
        """Fuse all jobs (TileJob-likes) through band tasks."""
        tasks, n_jobs = partition_jobs_by_band(jobs, self.tile_h,
                                               self.height, self.band)

        import threading
        done = [0]
        done_lock = threading.Lock()

        def progress():
            with done_lock:
                done[0] += 1
                n = done[0]
            if progress_cb is not None:
                progress_cb(n, n_jobs)

        cancelled = [False]

        def run_task(key):
            if cancelled[0]:
                return
            if stop_check is not None:
                stop_check()
            c, z, band0 = key
            import time as _time
            cpu0 = _time.thread_time()
            try:
                self._process_band(c, z, band0, tasks[key], load_fn,
                                   progress, stop_check=stop_check)
            finally:
                # compute-vs-wait split: stats[...] above are thread
                # WALL sums (they bill IO blocks and scheduler
                # starvation); 'cpu' is actual on-core time, the number
                # that bounds a full-core run
                with self._stats_lock:
                    self.stats['cpu'] = (self.stats.get('cpu', 0.0)
                                         + _time.thread_time() - cpu0)

        # (z, band0, c) order: all channels of one band row complete
        # near each other, so an RGB TIFF writer (which interleaves the
        # three channel bands per page strip) parks at most a few bands
        # — (c, z, band0) order would buffer channel 0's whole plane
        # before channel 1 started. Bands write disjoint rows, so
        # ordering is otherwise free.
        order = sorted(tasks.keys(), key=lambda k: (k[1], k[2], k[0]))
        pool = ThreadPoolExecutor(self.num_threads)
        try:
            list(pool.map(run_task, order))
        except BaseException:
            cancelled[0] = True
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        finally:
            pool.shutdown(wait=True)
        import time as _time
        t0 = _time.perf_counter()
        self._cpu_mark()
        self.writer.close()
        self._tick('close', t0)


class DeviceStreamingFuser:
    """Device-resident Y-band fusion: the device twin of StreamingFuser.

    The reference's canvas-free architecture (zarr_stitcher.py:421-489)
    with the canvas band living in HBM: tile batches fuse on device
    through the SAME jitted kernels as the in-RAM device path
    (ops/fuse.fuse_overwrite / fuse_feather), finished bands come back
    as one D2H slab and stream into the async writer while the next
    band fuses. Canvases beyond HBM capacity therefore stay on the
    device fusion path instead of falling back to the host.

    Placement parity trick: each band canvas carries a one-tile apron
    on ALL four sides, so a tile straddling the band's top edge keeps
    its full pre-crop slice origin in-bounds (the kernels' masks and
    ramps are evaluated on the whole tile exactly as in the in-RAM
    path) — band output is bit-identical to the unbanded device canvas.
    """

    def __init__(self, writer: MultiscaleWriter, num_c: int, num_z: int,
                 height: int, width: int, tile_h: int, tile_w: int, dtype,
                 num_levels: int, downsample_mode: str = 'nearest',
                 chunk_rows: int = 2048, batch_size: int = 8,
                 reader_threads: int = 4,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64):
        self.writer = writer
        self.num_c, self.num_z = num_c, num_z
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.num_levels = num_levels
        self.mode = downsample_mode
        self.band = band_rows_for(chunk_rows, num_levels)
        self.batch_size = batch_size
        self.reader_threads = reader_threads
        self.ff_recip = ff_recip
        self.blend = blend_method
        self.blend_px = blend_px
        self._ff_device = None  # lazy one-time H2D of the flatfields

    def _fuse_band(self, band0: int, band_jobs: Sequence,
                   progress_cb=None, stop_check=None) -> np.ndarray:
        import jax.numpy as jnp
        from ..io.readers import TileBatchLoader
        from ..ops import fuse as fuse_ops
        th, tw = self.tile_h, self.tile_w
        rows = min(self.band, self.height - band0)
        # apron: th above (straddlers from the previous band), th below +
        # tw right (dynamic_update_slice stays in-bounds, as in
        # ops/fuse.padded_canvas_shape)
        shape = (1, 1, th + self.band + th, self.width + tw)
        if self.blend == 'feather':
            acc = jnp.zeros(shape, jnp.float32)
            wsum = jnp.zeros(shape, jnp.float32)
        else:
            canvas = jnp.zeros(shape, self.dtype)
        if self._ff_device is None and self.ff_recip is not None:
            # upload the reciprocal stack once; every band reuses it
            self._ff_device = jnp.asarray(self.ff_recip)
        ff = self._ff_device

        # TileBatchLoader gives threaded decode + background prefetch
        # (the next batch loads while the device fuses this one) and the
        # canonical undersized-tile crop folding
        jobs = [j for j, _ in band_jobs]
        primaries = [p for _, p in band_jobs]
        loader = TileBatchLoader(jobs, self.batch_size, th, tw, self.dtype,
                                 num_threads=self.reader_threads)
        consumed = 0
        for batch in loader:
            if stop_check is not None:
                stop_check()  # per-batch cancellation
            dtiles = jnp.asarray(batch.tiles)
            info = jnp.asarray(batch.info)
            dcrops = jnp.asarray(batch.crops)
            dvalid = jnp.asarray(batch.valid)
            if ff is not None:
                dtiles = fuse_ops.apply_flatfield(dtiles, ff, info[:, 0],
                                                  self.dtype)
            # band-local coordinates: the +th apron keeps origins >= 0
            # for every REAL job; padding entries pin to 0 (their valid
            # mask is False, but the slice origin must stay in bounds)
            zero = jnp.zeros_like(info[:, 2])
            yb = jnp.where(dvalid, info[:, 2] - band0 + th, 0)
            xb = jnp.where(dvalid, info[:, 3], 0)
            dinfo = jnp.stack([zero, zero, yb, xb], axis=1)
            if self.blend == 'feather':
                acc, wsum = fuse_ops.fuse_feather(acc, wsum, dtiles, dinfo,
                                                  dcrops, dvalid,
                                                  blend_px=self.blend_px)
            else:
                canvas = fuse_ops.fuse_overwrite(canvas, dtiles, dinfo,
                                                 dcrops, dvalid)
            if progress_cb is not None:
                for p in primaries[consumed:consumed + batch.count]:
                    if p:
                        progress_cb()
            consumed += batch.count
        if self.blend == 'feather':
            canvas = fuse_ops.finalize_feather(acc, wsum, self.dtype)
        # D2H only the real rows/cols of this band. The transfer is
        # STARTED here but not waited on: the device array goes to the
        # background writer thread, which materializes it (np.asarray)
        # while the fusion loop dispatches the next band, so the band
        # readback overlaps the next band's compute.
        out = canvas[0, 0, th:th + rows, :self.width]
        try:
            out.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass  # non-jax arrays / backends without async copies
        return out

    def run(self, jobs: Sequence, load_fn: Callable = None,
            progress_cb: Optional[Callable[[int], None]] = None,
            stop_check: Optional[Callable] = None) -> None:
        """``load_fn`` is accepted for signature parity with the host
        fuser but unused: batches load through TileBatchLoader, which
        applies the canonical plane loader.

        Band writes run on one background thread behind a bounded
        hand-off (one band in flight): the device fuses band N+1 while
        band N's pyramid fold + (synchronous, on the raw path) chunk
        writes drain — without this the accelerator idles for the
        whole write stage of every band. Peak device memory grows by
        up to two band slabs (queue slot + the one the writer is
        draining) plus one host copy.
        Bands target disjoint rows, so write order across bands
        doesn't affect output; levels of ONE band stay ordered on the
        single writer thread."""
        tasks, n_jobs = partition_jobs_by_band(jobs, self.tile_h,
                                               self.height, self.band)
        done = [0]

        def progress():
            done[0] += 1
            if progress_cb is not None:
                progress_cb(done[0], n_jobs)

        import queue as _queue
        import threading
        handoff = _queue.Queue(maxsize=1)
        write_err: List = []

        def writer_loop():
            while True:
                item = handoff.get()
                if item is None:
                    return
                c, z, band0, buf = item
                try:
                    # blocks until the async D2H started by _fuse_band
                    # completes; overlaps with the next band's fusion
                    buf = np.asarray(buf)
                    write_band_levels(self.writer, c, z, band0, buf,
                                      self.num_levels, self.mode,
                                      self.width)
                except BaseException as e:  # surfaced on the main thread
                    write_err.append(e)
                    return

        wt = threading.Thread(target=writer_loop, name='band-writer',
                              daemon=True)
        wt.start()
        fuse_exc = None
        try:
            # (z, band0, c): see StreamingFuser.run — keeps the RGB TIFF
            # writer's per-page strip accumulation bounded
            for key in sorted(tasks.keys(),
                              key=lambda k: (k[1], k[2], k[0])):
                if stop_check is not None:
                    stop_check()
                if write_err:
                    break
                c, z, band0 = key
                buf = self._fuse_band(band0, tasks[key], progress,
                                      stop_check=stop_check)
                while not write_err:
                    try:
                        handoff.put((c, z, band0, buf), timeout=0.5)
                        break
                    except _queue.Full:
                        continue
                # drop the loop's reference: without this the slab
                # stays live in HBM until band N+1 finishes fusing,
                # raising peak device memory by a whole band
                buf = None
        except BaseException as e:
            fuse_exc = e
        # stop the writer: a blocking put is safe while it's alive (it
        # always drains); a dead one (write_err) just leaves the queue
        while wt.is_alive():
            if fuse_exc is not None:
                # cancellation/error: discard a band still waiting in
                # the hand-off — materializing and writing it would
                # delay the abort by a full band D2H + write for a run
                # that is being abandoned (a band the writer already
                # took finishes; mid-write interruption is not safe)
                try:
                    handoff.get_nowait()
                except _queue.Empty:
                    pass
            try:
                handoff.put(None, timeout=0.5)
                break
            except _queue.Full:
                continue
        wt.join()
        if fuse_exc is not None:
            raise fuse_exc
        if write_err:
            raise write_err[0]
        self.writer.close()
