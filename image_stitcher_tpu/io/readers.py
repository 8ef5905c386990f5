"""Threaded host-side tile loading: disk -> pinned batches for the device.

Replaces the reference's synchronous per-tile dask_imread calls inside the
stitch loop (stitcher.py:654) with a prefetching reader pool: images decode
on host threads (OpenCV releases the GIL) while the device fuses the
previous batch — the host->HBM double-buffering from SURVEY.md §7.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .acquisition import read_image


def load_tile_plane(job: "TileJob") -> np.ndarray:
    """Read the (th, tw) plane a TileJob refers to (RGB plane select,
    leading-singleton squeeze) — the one canonical plane loader.

    When the job carries a fractional placement residual (subpixel
    global positions), the plane is bilinearly shifted by it here, so
    every fusion backend places subpixel-corrected content.

    Planes come back mmap-backed (zero-copy) with kernel readahead
    kicked off up front: fusion touches most of the file, so cold-cache
    runs overlap disk I/O with placement instead of stalling on page
    faults, while tiles straddling a band boundary still cost one
    header parse per band instead of a full decode."""
    img = read_image(job.filepath, prefer_mmap=True, prefetch=True)
    if job.plane >= 0:
        img = img[:, :, job.plane]
    elif img.ndim == 3 and img.shape[0] == 1:
        img = img[0]
    if job.fy or job.fx:
        from .acquisition import import_cv2
        cv2 = import_cv2("subpixel placement")
        m = np.array([[1.0, 0.0, job.fx], [0.0, 1.0, job.fy]], np.float64)
        img = cv2.warpAffine(img, m, (img.shape[1], img.shape[0]),
                             flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_REPLICATE)
    return img


@dataclass(frozen=True)
class TileJob:
    """One monochrome plane destined for the canvas."""
    filepath: str
    plane: int            # -1 = grayscale file, 0/1/2 = RGB plane index
    channel_idx: int      # index into monochrome channels
    z_level: int
    y: int                # pre-crop top-left in canvas coords
    x: int
    crops: Tuple[int, int, int, int]  # top, bottom, left, right
    fy: float = 0.0       # fractional placement residual (subpixel mode)
    fx: float = 0.0


@dataclass
class TileBatch:
    tiles: np.ndarray     # (N, th, tw) native dtype
    info: np.ndarray      # (N, 4) int32 [c, z, y, x]
    crops: np.ndarray     # (N, 4) int32
    valid: np.ndarray     # (N,) bool
    count: int            # number of real (non-padding) entries


class TileBatchLoader:
    """Iterates fixed-size TileBatches with background prefetch.

    Batches have a static shape (batch_size, tile_h, tile_w) so the fusion
    kernel compiles once; the trailing batch is padded with valid=False.
    """

    def __init__(self, jobs: Sequence[TileJob], batch_size: int,
                 tile_h: int, tile_w: int, dtype,
                 num_threads: int = 8, prefetch: int = 2):
        self.jobs = list(jobs)
        self.batch_size = batch_size
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.num_threads = num_threads
        self.prefetch = prefetch

    def __len__(self) -> int:
        return (len(self.jobs) + self.batch_size - 1) // self.batch_size

    def _load_plane(self, job: TileJob) -> Tuple[np.ndarray, int, int]:
        img = load_tile_plane(job)
        tile = np.zeros((self.tile_h, self.tile_w), self.dtype)
        h = min(img.shape[0], self.tile_h)
        w = min(img.shape[1], self.tile_w)
        tile[:h, :w] = img[:h, :w]
        return tile, h, w

    def _build_batch(self, chunk: List[TileJob], pool: ThreadPoolExecutor) -> TileBatch:
        n = self.batch_size
        tiles = np.zeros((n, self.tile_h, self.tile_w), self.dtype)
        info = np.zeros((n, 4), np.int32)
        crops = np.zeros((n, 4), np.int32)
        valid = np.zeros((n,), bool)
        planes = list(pool.map(self._load_plane, chunk))
        for i, (job, (plane, h, w)) in enumerate(zip(chunk, planes)):
            tiles[i] = plane
            info[i] = (job.channel_idx, job.z_level, job.y, job.x)
            # undersized tiles fold the zero-pad deficit into the
            # bottom/right crops so padding never overwrites canvas
            # content. The host backends crop `bottom` rows off the
            # ACTUAL loaded shape (window ends at h - bottom), so in
            # nominal coordinates the crop is bottom + deficit.
            top, bottom, left, right = job.crops
            crops[i] = (top, bottom + (self.tile_h - h),
                        left, right + (self.tile_w - w))
            valid[i] = True
        return TileBatch(tiles, info, crops, valid, len(chunk))

    def __iter__(self) -> Iterator[TileBatch]:
        chunks = [self.jobs[i:i + self.batch_size]
                  for i in range(0, len(self.jobs), self.batch_size)]
        if not chunks:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # never block forever: the consumer may abandon iteration
            # (cancellation / error) without draining the queue
            while not abandoned.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                try:
                    for chunk in chunks:
                        if not put(self._build_batch(chunk, pool)):
                            return
                except Exception as e:  # surface in consumer
                    put(e)
                finally:
                    put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            t.join()
        finally:
            abandoned.set()


def expand_tile_jobs(monochrome_channels: Sequence[str],
                     rgb_channels: Sequence[str],
                     positions_and_crops) -> List[TileJob]:
    """Expand (TileRecord, (x, y), crops) triples into per-plane TileJobs.

    RGB tiles become three jobs (R/G/B planes into consecutive channel
    indices), matching reference place_tile (stitcher.py:550-556).
    """
    jobs: List[TileJob] = []
    for rec, pos, crops in positions_and_crops:
        x, y = pos[0], pos[1]
        fy, fx = (pos[3], pos[2]) if len(pos) > 2 else (0.0, 0.0)
        if rec.channel in rgb_channels:
            base = rec.channel.split('_')[0]
            for plane, suffix in enumerate('RGB'):
                cidx = monochrome_channels.index(f"{base}_{suffix}")
                jobs.append(TileJob(rec.filepath, plane, cidx, rec.z_level,
                                    y, x, tuple(crops), fy, fx))
        else:
            cidx = monochrome_channels.index(rec.channel)
            jobs.append(TileJob(rec.filepath, -1, cidx, rec.z_level,
                                y, x, tuple(crops), fy, fx))
    return jobs
