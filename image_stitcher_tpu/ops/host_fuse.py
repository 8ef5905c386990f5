"""Host-side parallel fusion backend (thread pool over NumPy slices).

The fusion stage is pure data movement (tile bytes -> canvas bytes ->
disk). This backend assembles the canvas in host RAM; it is the fusion
path on the CPU backend (EngineOptions.fusion_device='auto' picks the
device canvas on a GPU), and the reference the device paths are tested
against.

Semantics are identical to ops/fuse.fuse_overwrite (and to the reference
placement, stitcher.py:563-605): later tile wins, crop masks, edge clamp.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np


def correct_tile(tile: np.ndarray, ff_recip: Optional[np.ndarray],
                 c: int, dtype: np.dtype) -> np.ndarray:
    """Reference flatfield correction (stitcher.py:607-611) expressed as
    multiply-by-reciprocal, clip to dtype range, cast. Every backend —
    this NumPy twin, the C kernel, and the device op — multiplies by the
    same host-computed reciprocal so outputs stay byte-identical on any
    device whose f32 divide is reciprocal-approximated."""
    if ff_recip is None:
        return tile
    # undersized edge tiles: correct by the matching top-left window of
    # the nominal-size field (the C kernel indexes ff per pixel the
    # same way)
    corrected = tile * ff_recip[c][:tile.shape[0], :tile.shape[1]]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        np.clip(corrected, info.min, info.max, out=corrected)
    return corrected.astype(dtype)


def place_window_native(dst, tile: np.ndarray, ff_c: Optional[np.ndarray],
                        y0: int, y1: int, x0: int, x1: int,
                        cy: int, cx: int,
                        feather: Optional[Tuple] = None) -> bool:
    """Fused C divide-clip-cast-place of tile[y0:y1, x0:x1] at dst[cy, cx].

    The one native entry point shared by HostCanvas and StreamingFuser
    (native/hostops.c). ``dst`` is a 2D plane whose dtype equals the
    tile's (overwrite), or an (acc, wsum) float32 pair (feather).
    ``ff_c`` is the per-channel (th, tw) float32 RECIPROCAL flatfield
    or None.
    ``feather`` = (wy0, wy1, wx0, wx1, inv_blend_px): the FULL crop
    window in tile coordinates that feather ramps measure from.
    Returns False when this job can't take the native path (no library,
    unsupported dtype/layout) so callers fall back to NumPy.
    """
    from .. import native
    lib = native.get_lib()
    if lib is None or not tile.flags['C_CONTIGUOUS']:
        return False
    if tile.dtype == np.uint16:
        suffix, fmax = 'u16', 2
    elif tile.dtype == np.uint8:
        suffix, fmax = 'u8', 1
    else:
        return False
    if ff_c is not None and (ff_c.dtype != np.float32
                             or not ff_c.flags['C_CONTIGUOUS']):
        return False
    ffp = ff_c.ctypes.data if ff_c is not None else None
    ffs = ff_c.strides[0] // 4 if ff_c is not None else 0
    if feather is not None:
        acc, wsum = dst
        wy0, wy1, wx0, wx1, inv_px = feather
        getattr(lib, f'feather_{suffix}')(
            acc.ctypes.data, wsum.ctypes.data, acc.strides[0] // 4,
            tile.ctypes.data, tile.strides[0] // fmax,
            ffp, ffs, y0, y1, x0, x1,
            wy0, wy1, wx0, wx1, cy, cx, inv_px)
        return True
    if dst.dtype != tile.dtype:
        return False
    getattr(lib, f'place_{suffix}')(
        dst.ctypes.data, dst.strides[0] // fmax,
        tile.ctypes.data, tile.strides[0] // fmax,
        ffp, ffs, y0, y1, x0, x1, cy, cx)
    return True


class HostCanvas:
    """A (C, Z, H, W) canvas fused by a host thread pool."""

    def __init__(self, num_c: int, num_z: int, height: int, width: int,
                 dtype, num_threads: int = 4,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64):
        self.height, self.width = height, width
        self.dtype = np.dtype(dtype)
        self.ff_recip = ff_recip  # (C, th, tw) f32 reciprocal or None
        self.blend = blend_method
        self.blend_px = blend_px
        if blend_method == 'feather':
            # native-dtype canvas materializes at finalize() only
            self.canvas = None
            self.acc = np.zeros((num_c, num_z, height, width), np.float32)
            self.wsum = np.zeros((num_c, num_z, height, width), np.float32)
        else:
            self.canvas = np.zeros((num_c, num_z, height, width), dtype)
        self.pool = ThreadPoolExecutor(max_workers=num_threads)

    def _correct(self, tile: np.ndarray, c: int) -> np.ndarray:
        return correct_tile(tile, self.ff_recip, c, self.dtype)

    def _place_native(self, tile, c, z, yy, xx, y0, y1, x0, x1,
                      wy1, wx1) -> bool:
        """Fused C kernel (shared place_window_native); False = fall back."""
        ff_c = self.ff_recip[c] if self.ff_recip is not None else None
        if self.blend == 'feather':
            return place_window_native(
                (self.acc[c, z], self.wsum[c, z]), tile, ff_c,
                y0, y1, x0, x1, yy, xx,
                feather=(y0, wy1, x0, wx1, 1.0 / float(self.blend_px)))
        return place_window_native(self.canvas[c, z], tile, ff_c,
                                   y0, y1, x0, x1, yy, xx)

    def _place(self, job) -> None:
        tile, c, z, y, x, crops = job
        top, bottom, left, right = crops
        th, tw = tile.shape
        # full crop window within the tile (feather ramps measure from
        # these edges, matching the device kernel), then canvas clamp
        wy1 = th - bottom if bottom else th
        wx1 = tw - right if right else tw
        y0, y1 = top, wy1
        x0, x1 = left, wx1
        yy, xx = y + top, x + left
        y1 = min(y1, y0 + (self.height - yy))
        x1 = min(x1, x0 + (self.width - xx))
        if y1 <= y0 or x1 <= x0:
            return

        if self.dtype == tile.dtype and self._place_native(
                tile, c, z, yy, xx, y0, y1, x0, x1, wy1, wx1):
            return

        t = self._correct(tile, c)[y0:y1, x0:x1]
        ye, xe = yy + (y1 - y0), xx + (x1 - x0)
        if self.blend == 'feather':
            dy = np.minimum(np.arange(y0, y1) - y0 + 1,
                            wy1 - np.arange(y0, y1))
            dx = np.minimum(np.arange(x0, x1) - x0 + 1,
                            wx1 - np.arange(x0, x1))
            wgt = (np.minimum.outer(dy, dx).astype(np.float32)
                   / self.blend_px).clip(0, 1)
            self.acc[c, z, yy:ye, xx:xe] += wgt * t.astype(np.float32)
            self.wsum[c, z, yy:ye, xx:xe] += wgt
        else:
            self.canvas[c, z, yy:ye, xx:xe] = t

    def fuse(self, jobs: Sequence[Tuple]) -> None:
        """jobs: (tile(th,tw), c, z, y, x, crops).

        Jobs are grouped by (c, z) plane: planes fuse concurrently (they
        can never overlap), while jobs within a plane apply sequentially
        in order — preserving the reference's later-tile-wins semantics
        exactly, with no data races (the reference's Pool relied on
        registration crops making writes disjoint, zarr_stitcher.py:421-440;
        we don't need that assumption).
        """
        planes = {}
        for job in jobs:
            planes.setdefault((job[1], job[2]), []).append(job)

        def run_plane(plane_jobs):
            for job in plane_jobs:
                self._place(job)

        try:
            list(self.pool.map(run_plane, planes.values()))
        except BaseException:
            self.pool.shutdown(wait=False, cancel_futures=True)
            raise

    def fuse_streaming(self, jobs, load_fn, progress_cb=None,
                       stop_check=None) -> None:
        """Read-and-place directly: no intermediate batch buffers.

        ``jobs`` are TileJob-likes (attrs channel_idx, z_level, y, x,
        crops); ``load_fn(job)`` returns the (th, tw) plane. Jobs are
        partitioned by (c, z) plane; each plane streams sequentially in
        order (exact overwrite semantics), planes in parallel.
        """
        import threading
        planes = {}
        for job in jobs:
            planes.setdefault((job.channel_idx, job.z_level), []).append(job)
        done = [0]
        done_lock = threading.Lock()

        cancelled = [False]

        def run_plane(plane_jobs):
            for job in plane_jobs:
                if cancelled[0]:
                    return
                if stop_check is not None:
                    stop_check()
                tile = load_fn(job)
                self._place((tile, job.channel_idx, job.z_level,
                             job.y, job.x, job.crops))
                with done_lock:
                    done[0] += 1
                    n = done[0]
                if progress_cb is not None:
                    progress_cb(n)

        try:
            list(self.pool.map(run_plane, planes.values()))
        except BaseException:
            cancelled[0] = True  # running planes bail at their next job
            self.pool.shutdown(wait=False, cancel_futures=True)
            raise

    def finalize(self) -> np.ndarray:
        if self.blend == 'feather':
            self.canvas = finalize_feather_host(self.acc, self.wsum,
                                                self.dtype)
        self.pool.shutdown(wait=True)
        return self.canvas


def finalize_feather_host(acc: np.ndarray, wsum: np.ndarray,
                          dtype) -> np.ndarray:
    """(acc, wsum) f32 -> storage dtype, semantics of the NumPy chain
    ``clip(round(acc / maximum(wsum, 1e-6))); 0 where wsum==0`` in a
    single native pass (native/hostops.c finalize_feather_*). The NumPy
    fallback IS that chain, so results are bit-identical either way
    (rintf == np.round: both round half to even).

    Accepts any leading shape with C-contiguous trailing rows; the
    native path additionally requires acc/wsum to share a layout.
    """
    dtype = np.dtype(dtype)
    from ..native import get_lib
    lib = get_lib()
    fn = None
    if lib is not None and hasattr(lib, 'finalize_feather_u16'):
        fn = {np.dtype(np.uint16): lib.finalize_feather_u16,
              np.dtype(np.uint8): lib.finalize_feather_u8}.get(dtype)
    es = acc.dtype.itemsize
    if (fn is not None and acc.dtype == np.float32
            and wsum.dtype == np.float32
            and acc.shape == wsum.shape and acc.strides == wsum.strides
            and acc.strides[-1] == es and acc.ndim >= 2):
        out = np.empty(acc.shape, dtype)
        a3 = acc.reshape((-1,) + acc.shape[-2:]) \
            if acc.ndim != 2 else acc[None]
        w3 = wsum.reshape((-1,) + wsum.shape[-2:]) \
            if wsum.ndim != 2 else wsum[None]
        o3 = out.reshape((-1,) + out.shape[-2:]) \
            if out.ndim != 2 else out[None]
        if a3.strides[-1] == es and a3.strides == w3.strides:
            for i in range(a3.shape[0]):
                fn(a3[i].ctypes.data, w3[i].ctypes.data,
                   a3[i].strides[0] // es,
                   o3[i].ctypes.data, o3[i].strides[0] // dtype.itemsize,
                   a3.shape[-2], a3.shape[-1])
            return out
    out_f = acc / np.maximum(wsum, 1e-6)
    out_f[wsum == 0] = 0
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out_f = np.clip(np.round(out_f), info.min, info.max)
    return out_f.astype(dtype)


def _downsample2x_native(x: np.ndarray, out_h: int, out_w: int,
                         mode: str = 'nearest', out: np.ndarray = None):
    """C 2x downsample (native/hostops.c); None -> NumPy fallback.

    'nearest' copies exactly the elements of x[::2, ::2]. 'mean' (uint
    only) computes floor(mean of each 2x2 window) with integer
    arithmetic — bit-identical to the NumPy float32 path because the
    4-term sum is < 2^24 (exact in f32) and /4 is a power of two.

    ``out`` (2-D inputs only): write the result into this array — rows
    may be strided (a column slice of a wider buffer), so the block-
    banding fuser can downsample chunk blocks straight into their
    columns of a pooled level-1 band with no concatenate copy."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, 'downsample2x2_mean_u16'):
        return None
    fn = {('nearest', np.dtype(np.uint16)): lib.downsample2x_u16,
          ('nearest', np.dtype(np.uint8)): lib.downsample2x_u8,
          ('mean', np.dtype(np.uint16)): lib.downsample2x2_mean_u16,
          ('mean', np.dtype(np.uint8)): lib.downsample2x2_mean_u8,
          }.get((mode, x.dtype))
    if fn is None:
        return None
    if out_h <= 0 or out_w <= 0 or x.strides[-1] != x.dtype.itemsize:
        return None
    es = x.dtype.itemsize
    if (out is not None and x.ndim == 2 and out.ndim == 2
            and out.dtype == x.dtype and out.shape == (out_h, out_w)
            and out.strides[-1] == es):
        fn(x.ctypes.data, x.strides[0] // es,
           out.ctypes.data, out.strides[0] // es, out_h, out_w)
        return out
    lead = x.shape[:-2]
    src = x.reshape((-1,) + x.shape[-2:]) if lead else x[None]
    if src.strides[-1] != x.dtype.itemsize:
        return None
    res = np.empty((src.shape[0], out_h, out_w), x.dtype)
    for i in range(src.shape[0]):
        plane = src[i]
        fn(plane.ctypes.data, plane.strides[0] // es,
           res[i].ctypes.data, res[i].strides[0] // es, out_h, out_w)
    return res.reshape(lead + (out_h, out_w))


def host_downsample(x: np.ndarray, mode: str,
                    out: np.ndarray = None) -> np.ndarray:
    """NumPy twin of ops/pyramid.downsample (levels from the host canvas).

    ``out`` (2-D inputs only) writes the result in place — see
    :func:`_downsample2x_native`. Every path honors it: the fallbacks
    copy, and a shape/dtype mismatch raises rather than silently
    returning a fresh array (a caller that passed ``out`` is reusing a
    pooled buffer and must be able to rely on it being filled)."""
    if out is not None and (x.ndim != 2 or out.ndim != 2):
        raise ValueError('host_downsample out= requires 2-D in and out')
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    if out is not None and (out.shape != (h2 // 2, w2 // 2)
                            or out.dtype != x.dtype):
        raise ValueError(
            f'host_downsample out= shape/dtype mismatch: '
            f'{out.shape}/{out.dtype} vs {(h2 // 2, w2 // 2)}/{x.dtype}')
    res = _downsample2x_native(x, h2 // 2, w2 // 2, mode, out=out)
    if res is not None:
        if out is not None and res is not out:
            np.copyto(out, res)
            return out
        return res
    if mode == 'nearest':
        r = x[..., :h2:2, :w2:2]
        if out is not None:
            np.copyto(out, r)
            return out
        return np.ascontiguousarray(r)
    t = x[..., :h2, :w2].astype(np.float32)
    lead = t.shape[:-2]
    m = t.reshape(lead + (h2 // 2, 2, w2 // 2, 2)).mean(axis=(-3, -1))
    if np.issubdtype(x.dtype, np.integer):
        # trunc, not floor: astype-from-float truncates toward zero, and
        # floor would bias negative values of signed canvases by -1
        m = np.trunc(m)
    m = m.astype(x.dtype)
    if out is not None:
        np.copyto(out, m)
        return out
    return m
