"""O_DIRECT write path for the raw chunk/shard writers (io/raw_zarr.py).

Why this exists (measured on the bench host, single schedulable core):
buffered writes burst at page-cache speed (~4 GB/s) until the dirty
window fills (~1 GB here), then collapse to ~180 MB/s while the same
core pays for the user->cache copy, dirty-page balancing, AND kernel
writeback; O_DIRECT sustains the device's real ~550 MB/s with one DMA
and no cache pollution (the input tiles stay resident). A full bench
rep spent 19 s of 29 s inside pwritev before this path existed.

The decision is measured, not configured: ``probe_direct_io`` writes a
~256 MB interleaved A/B (buffered+fdatasync vs O_DIRECT) once per
(device, cpu-count) with a 24 h disk cache. Buffered is charged its fdatasync
because the raw writers only serve multi-GB streaming outputs, where
writeback lands inline once the dirty window is exhausted; on hosts
with spare cores and fast disks the two arms tie and buffered keeps the
page-cache benefit (direct needs a 1.3x win).

Alignment: O_DIRECT requires buffer/length/offset aligned to the
logical block size (4096 covers every common device). Chunk rows are
packed into a page-aligned per-thread staging buffer (one extra memcpy
at memory speed — noise next to the 3x device-rate win), and any call
whose offset/length cannot align falls back to the buffered pwritev
kernel for that call alone.

Reference context: the save stage is the reference's known wall — its
only benchmark harness exists to optimize it
(/root/reference/save_region_test.py:126-179).
"""

from __future__ import annotations

import json
import mmap
import os
import threading
import time
from typing import Dict, Optional

ALIGN = 4096
_PROBE_TTL_S = 24 * 3600
_PROBE_MB = 256          # per arm; bounded — sees the burst, not the knee
# Decision rule: a bounded probe cannot reach the dirty-window knee
# (~1 GB here) where buffered collapses (measured: 401 MB/s at probe
# scale -> 123 MB/s sustained at 4 GB, while direct's probe rate IS its
# sustained rate). So direct wins whenever it reaches a sizable
# fraction of the buffered BURST: on starved hosts the two probe within
# ~10% and sustained direct is 2-3x better (full reps: 10.4 s vs
# 27.3 s); on healthy hosts the buffered burst is pure memcpy (several
# GB/s, writeback absorbed by spare cores) and direct probes far below
# the threshold, keeping the page-cache path.
_WIN_RATIO = 0.7         # direct must reach 70% of the buffered burst

_cache_lock = threading.Lock()
_mem_cache: Dict[str, Optional[dict]] = {}


def _cache_path() -> str:
    return os.path.expanduser(
        "~/.cache/image_stitcher_tpu/directio.json")


def _cache_key(dir_path: str) -> str:
    try:
        dev = os.stat(dir_path).st_dev
    except OSError:
        dev = -1
    return f"dev{dev}-cpu{os.cpu_count()}"


def _write_arm(dir_path: str, direct: bool, payload, n_mb: int) -> float:
    """MB/s of one arm. Buffered is charged an fdatasync (steady-state
    model for multi-GB outputs); direct is synchronous by nature."""
    path = os.path.join(dir_path, f".directio_probe_{os.getpid()}")
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    if direct:
        flags |= os.O_DIRECT
    t0 = time.perf_counter()
    fd = os.open(path, flags, 0o644)
    try:
        for _ in range(n_mb // 16):
            os.write(fd, payload)
        if not direct:
            os.fdatasync(fd)
    finally:
        os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass
    return n_mb / (time.perf_counter() - t0)


def probe_direct_io(dir_path: str, force: bool = False) -> Optional[dict]:
    """Measured buffered-vs-direct write rates for ``dir_path``'s
    device, disk-cached. None = O_DIRECT unusable there (tmpfs, FUSE)."""
    key = _cache_key(dir_path)
    with _cache_lock:
        if not force and key in _mem_cache:
            return _mem_cache[key]
        cache_file = _cache_path()
        if not force:
            try:
                with open(cache_file) as f:
                    entry = json.load(f).get(key)
                if entry and time.time() - entry["ts"] < _PROBE_TTL_S:
                    _mem_cache[key] = entry
                    return entry
            except (OSError, ValueError, KeyError):
                pass
        mm = mmap.mmap(-1, 16 << 20)  # page-aligned: legal for O_DIRECT
        mm.write(os.urandom(1 << 20) * 16)
        payload = memoryview(mm)
        entry: Optional[dict]
        try:
            buffered = direct = 0.0
            for _ in range(2):  # interleaved: both arms see both weathers
                buffered = max(buffered,
                               _write_arm(dir_path, False, payload,
                                          _PROBE_MB // 2))
                direct = max(direct,
                             _write_arm(dir_path, True, payload,
                                        _PROBE_MB // 2))
            entry = {"ts": time.time(), "buffered_mbps": round(buffered, 1),
                     "direct_mbps": round(direct, 1)}
        except OSError:
            # O_DIRECT open/write refused on this filesystem
            entry = {"ts": time.time(), "buffered_mbps": 0.0,
                     "direct_mbps": 0.0, "unsupported": True}
        finally:
            payload.release()
            mm.close()
        try:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            try:
                with open(cache_file) as f:
                    all_entries = json.load(f)
            except (OSError, ValueError):
                all_entries = {}
            all_entries[key] = entry
            tmp = f"{cache_file}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(all_entries, f)
            os.replace(tmp, cache_file)
        except OSError:
            pass
        _mem_cache[key] = entry
        return entry


def use_direct_io(dir_path: str, mode: str = 'auto') -> bool:
    """Resolve an EngineOptions-style direct_io knob ('auto'/'on'/'off',
    overridable by ISTPU_DIRECT_IO) into a decision for this path."""
    mode = os.environ.get('ISTPU_DIRECT_IO', '') or mode
    if mode == 'off':
        return False
    if mode == 'on':
        return True
    entry = probe_direct_io(dir_path)
    if not entry or entry.get("unsupported"):
        return False
    return entry["direct_mbps"] >= _WIN_RATIO * entry["buffered_mbps"]


class AlignedStaging:
    """Per-thread page-aligned staging buffers for O_DIRECT packing."""

    def __init__(self, nbytes: int):
        import numpy as np
        self.nbytes = -(-nbytes // ALIGN) * ALIGN
        self._tls = threading.local()
        self._np = np

    def get(self):
        buf = getattr(self._tls, 'buf', None)
        if buf is None or buf.nbytes < self.nbytes:
            mm = mmap.mmap(-1, self.nbytes)
            buf = self._np.frombuffer(mm, self._np.uint8)
            self._tls.buf = buf
            self._tls.mm = mm  # keep the mapping alive
        return buf


def pwrite_direct(fd: int, staging, plane, dtype, src_row0: int,
                  src_col0: int, nrows: int, row_bytes: int,
                  pitch: int, off0: int) -> None:
    """Pack ``nrows`` strided plane rows (+ zero pad to ``pitch``) into
    the aligned staging buffer and pwrite them at ``off0``.

    Caller guarantees: fd opened with O_DIRECT, off0 % ALIGN == 0,
    (nrows * pitch) % ALIGN == 0.
    """
    import numpy as np
    total = nrows * pitch
    buf = staging.get()
    rec_elems = pitch // dtype.itemsize
    w = row_bytes // dtype.itemsize
    view = buf[:total].view(dtype).reshape(nrows, rec_elems)
    view[:, :w] = plane[src_row0:src_row0 + nrows,
                        src_col0:src_col0 + w]
    if w < rec_elems:
        view[:, w:] = 0
    done = 0
    mv = memoryview(buf)[:total]
    while done < total:
        done += os.pwrite(fd, mv[done:], off0 + done)
