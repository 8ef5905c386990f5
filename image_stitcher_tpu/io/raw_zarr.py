"""Direct chunk-file writer for raw (uncompressed) zarr v2 arrays.

The streaming fusers emit full-width band slabs. For compressor-null
arrays a chunk body is just a C-order byte slab, so each chunk file can
be written straight from the band buffer with ``pwritev`` — one strided
iovec per row — skipping tensorstore's per-chunk assembly copy and
write machinery. Controlled interleaved measurement (production band
pattern, 2048 chunks): direct ~3.1-3.2 GB/s vs tensorstore
~1.2-1.7 GB/s of single-core write CPU, and the gap widens on starved
cores (tensorstore has measured ~0.4 GB/s in a storm window). On the
one-core hosts this framework targets (reference context: save
dominates, see /root/reference/save_region_test.py:126-179) that is
the difference between the writer being the wall and keeping up.

Parity contract (tested in tests/test_raw_zarr.py): chunk files are
byte-identical to what tensorstore writes for the same data — full-size
bodies, edge chunks zero-padded, nested ``t/c/z/cy/cx`` keys for
dimension_separator '/'. Rows a band never touches stay sparse file
zeros, which read identically to written fill-value zeros (fill must be
0; anything else falls back to tensorstore).

This writer only covers the slab patterns the fusers produce (single
(t, c, z) planes, x starting at 0, C-contiguous rows). ``try_write``
returns False for anything else. For zarr v3 the caller then falls back
to tensorstore; raw zarr v2 output (io/omezarr.MultiscaleWriter) is
written by this module alone and treats a refusal as an error. Without
the native kernel, rows are written with NumPy and ``os.pwrite``.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..native import get_lib

_CRC32C_TABLE: Optional[List[int]] = None


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as required by the zarr v3 sharding index
    codec. Table-based — the index is a few hundred bytes per shard."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            tbl.append(c)
        _CRC32C_TABLE = tbl
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _pwrite_all(fd: int, data, offset: int) -> None:
    done = 0
    while done < len(data):
        done += os.pwrite(fd, data[done:], offset + done)


class _RawSlabWriterBase:
    """Shared slab validation + per-plane dispatch for the raw chunk
    (v2) and shard (v3) writers. Subclasses implement
    ``_write_plane_slab(t, c, z, y0, plane)``."""

    # set by subclass __init__
    ok: bool
    shape: Tuple[int, ...]
    dtype: np.dtype

    def _init_direct(self, direct_io: str, *aligned_sizes: int) -> None:
        """Resolve the O_DIRECT decision for this writer (io/directio):
        measured probe says direct wins AND every write offset/length
        this writer produces is block-aligned (they are all multiples of
        the given sizes). On hosts where buffered writes collapse to
        writeback speed on the writing core (measured 180 vs 550 MB/s
        here), this is the single biggest write-stage lever."""
        from .directio import ALIGN, AlignedStaging, use_direct_io
        self.direct = (all(s > 0 and s % ALIGN == 0 for s in aligned_sizes)
                       and use_direct_io(os.path.dirname(self.path)
                                         or '.', direct_io))
        self._staging = (AlignedStaging(max(aligned_sizes))
                         if self.direct else None)

    def _open_chunk(self, fpath: str) -> Tuple[int, bool]:
        """(fd, is_direct): O_DIRECT when enabled, falling back to a
        plain open (and disabling direct for good) if the fs refuses."""
        if self.direct:
            try:
                return os.open(fpath,
                               os.O_WRONLY | os.O_CREAT | os.O_DIRECT,
                               0o644), True
            except OSError:
                self.direct = False  # e.g. tmpfs: EINVAL forever
        return os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644), False

    #: True when a tensorstore fallback write to the same array makes
    #: later raw writes unsafe — the owning MultiscaleWriter then sets
    #: ``ok = False`` after the first fallback. True for BOTH writers:
    #: v3 shards repack bodies, and v2 raw writes zero-pad each touched
    #: chunk row's x-tail, which would erase a prior fallback write
    #: sitting to the right of the slab in the same rows.
    disable_on_fallback = True

    def _pwrite_rows(self, fd: int, plane: np.ndarray, src_row0: int,
                     src_col0: int, nrows: int, row_bytes: int,
                     pad_bytes: int, off0: int, fpath: str,
                     is_direct: bool = False) -> None:
        """Stream ``nrows`` strided plane rows (+ zero padding to the
        chunk pitch) into a contiguous file region — O_DIRECT via the
        aligned staging pack, else the pwritev C kernel."""
        if is_direct:
            # NOT zero-copy on purpose: a gather-pwritev straight from
            # an aligned strided source (page-aligned band pool, 4096-
            # multiple pitch) was measured 15-20% SLOWER than this
            # pack-then-one-contiguous-pwrite on the bench device
            # (847-1174 vs 1075-1402 MB/s interleaved best-of-3) — the
            # kernel pins and splits 2048 scattered 4 KiB iovec segments
            # per chunk, which costs more than the 8 MiB staging memcpy
            # saves. Revisit only with a chunk-contiguous band layout
            # (single iovec, no pack).
            from .directio import pwrite_direct
            pwrite_direct(fd, self._staging, plane, self.dtype, src_row0,
                          src_col0, nrows, row_bytes,
                          row_bytes + pad_bytes, off0)
            return
        lib = get_lib()
        if lib is None or not hasattr(lib, 'write_rows_contig'):
            rows = plane[src_row0:src_row0 + nrows,
                         src_col0:src_col0 + row_bytes // self.dtype.itemsize]
            buf = np.zeros((nrows, row_bytes + pad_bytes), np.uint8)
            buf[:, :row_bytes] = rows.view(np.uint8).reshape(nrows, -1)
            _pwrite_all(fd, memoryview(buf).cast('B'), off0)
            return
        rc = lib.write_rows_contig(
            fd,
            ctypes.c_void_p(plane.ctypes.data
                            + src_row0 * plane.strides[0]
                            + src_col0 * self.dtype.itemsize),
            plane.strides[0], nrows, row_bytes,
            ctypes.cast(self._pad, ctypes.c_void_p) if pad_bytes else None,
            pad_bytes, off0)
        if rc < 0:
            raise OSError(int(-rc), os.strerror(int(-rc)), fpath)

    def try_write(self, sel: Optional[Tuple], data: np.ndarray) -> bool:
        """Write a 5D slab if this writer supports its layout.

        Returns True when handled; False means the caller must route the
        write through tensorstore instead (unsupported pattern — never a
        partial write).
        """
        if not self.ok:
            return False
        data = np.asarray(data)
        if data.dtype != self.dtype or data.ndim != 5:
            return False
        if sel is None:
            sel = tuple(slice(0, s) for s in self.shape)
        if len(sel) != len(self.shape):
            # zip() below would silently truncate a short sel and the
            # x-axis checks would index past it — route to tensorstore
            # (never-crash fallback contract) instead
            return False
        idx = []
        for s, dim in zip(sel, self.shape):
            # open slices (slice(None), slice(a, None)) normalize to
            # the array extent — the merge paths select whole c/z axes
            try:
                if s.step not in (None, 1):
                    return False
                idx.append((int(s.start) if s.start is not None else 0,
                            int(s.stop) if s.stop is not None else dim))
            except (AttributeError, TypeError):
                return False
        if any((b - a) != n for (a, b), n in zip(idx, data.shape)):
            return False
        # every axis must stay inside the array — a slab past the grid
        # would write stray files (v2) or hit absent index slots (v3)
        if any(a < 0 or b > s for (a, b), s in zip(idx, self.shape)):
            return False
        # x must additionally start at column 0 (zero-padding the tail
        # of each touched chunk is only correct when nothing sits to
        # the left)
        if idx[4][0] != 0:
            return False
        if data.strides[4] != self.dtype.itemsize:
            return False
        for it in range(data.shape[0]):
            for ic in range(data.shape[1]):
                for iz in range(data.shape[2]):
                    plane = data[it, ic, iz]
                    if plane.shape[0] == 0 or plane.shape[1] == 0:
                        continue
                    self._write_plane_slab(
                        idx[0][0] + it, idx[1][0] + ic, idx[2][0] + iz,
                        idx[3][0], plane)
        return True


class RawV2SlabWriter(_RawSlabWriterBase):
    """Writes band slabs into one raw zarr v2 array's chunk files."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype,
                 dimension_separator: str = '/', fill_value=0,
                 direct_io: str = 'auto'):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        # mirror create_zarr_array's clamp so the grid matches .zarray
        self.chunks = tuple(min(int(c), int(s)) if s > 0 else int(c)
                            for c, s in zip(chunks, self.shape))
        self.dtype = np.dtype(dtype)
        self.sep = dimension_separator
        self.ok = (fill_value == 0 and self.sep in ('/', '.')
                   and len(self.shape) == 5
                   # chunk keys and chunk_bytes assume one (t,c,z) plane
                   # per chunk file; a leading extent > 1 would key files
                   # by raw plane index and size them for a single plane
                   # — unreadable stores, not just a slow path
                   and self.chunks[:3] == (1, 1, 1))
        cy, cx = self.chunks[3], self.chunks[4]
        self.pitch = cx * self.dtype.itemsize
        self.chunk_bytes = cy * self.pitch
        self._pad = ctypes.create_string_buffer(self.pitch)
        self._made_dirs = set()
        # every v2 write offset/length is a multiple of pitch; staging
        # must hold a full chunk
        self._init_direct(direct_io if self.ok else 'off',
                          self.pitch, self.chunk_bytes)

    # ------------------------------------------------------------------

    def _chunk_file(self, t: int, c: int, z: int, cyi: int, cxi: int) -> str:
        key = (str(t), str(c), str(z), str(cyi), str(cxi))
        if self.sep == '/':
            d = os.path.join(self.path, *key[:-1])
            if d not in self._made_dirs:
                os.makedirs(d, exist_ok=True)
                self._made_dirs.add(d)
            return os.path.join(d, key[-1])
        return os.path.join(self.path, '.'.join(key))

    def _write_plane_slab(self, t: int, c: int, z: int, y0: int,
                          plane: np.ndarray) -> None:
        """Write plane (h, w) at rows [y0, y0+h), cols [0, w)."""
        cy, cx = self.chunks[3], self.chunks[4]
        itemsize = self.dtype.itemsize
        h, w = plane.shape
        y1 = y0 + h
        for cyi in range(y0 // cy, (y1 - 1) // cy + 1):
            ry0, ry1 = max(y0, cyi * cy), min(y1, (cyi + 1) * cy)
            nrows = ry1 - ry0
            full_y = (ry0 == cyi * cy and nrows == cy)
            off0 = (ry0 - cyi * cy) * self.pitch
            for cxi in range((w - 1) // cx + 1):
                x0, x1 = cxi * cx, min(w, (cxi + 1) * cx)
                fpath = self._chunk_file(t, c, z, cyi, cxi)
                fd, is_direct = self._open_chunk(fpath)
                try:
                    if not full_y and os.fstat(fd).st_size < self.chunk_bytes:
                        # sparse-extend: untouched rows read as fill zeros
                        os.ftruncate(fd, self.chunk_bytes)
                    row_bytes = (x1 - x0) * itemsize
                    self._pwrite_rows(fd, plane, ry0 - y0, x0, nrows,
                                      row_bytes, self.pitch - row_bytes,
                                      off0, fpath, is_direct)
                finally:
                    os.close(fd)

    # -------------------------------------------------- chunk-block API

    def block_spec(self):
        """(chunk_rows, chunk_cols) when this writer accepts chunk-
        contiguous block writes, else None. A fuser that lays its band
        out as chunk-column blocks gets single-contiguous-pwrite chunk
        files — no row gather, no staging pack."""
        return (self.chunks[3], self.chunks[4]) if self.ok else None

    def try_write_block(self, t: int, c: int, z: int, y0: int,
                        cxi: int, block: np.ndarray) -> bool:
        """Write one chunk-column block: ``block`` is (rows, chunk_cols)
        C-contiguous, covering canvas rows [y0, y0+rows) of chunk column
        ``cxi``, with any columns beyond the canvas width already zero
        (exactly the bytes a v2 chunk file stores — the row path
        zero-pads tails to the same effect). ``y0`` must sit on a chunk-
        row boundary; rows may span several chunk rows (each chunk row's
        span within the block is itself contiguous, so every chunk file
        gets ONE contiguous pwrite).

        Returns False (nothing written) for any shape/alignment outside
        that contract. The owning MultiscaleWriter treats a refusal as
        a mixing hazard and permanently routes the level through
        tensorstore — callers must satisfy the contract up front (the
        streaming fuser's pooled blocks do by construction).
        """
        if not self.ok:
            return False
        cy, cx = self.chunks[3], self.chunks[4]
        rows = block.shape[0]
        if (block.dtype != self.dtype or block.ndim != 2
                or block.shape[1] != cx
                or not block.flags.c_contiguous
                or y0 % cy != 0 or rows <= 0
                or y0 + rows > self.shape[3]
                or cxi < 0 or cxi >= -(-self.shape[4] // cx)):
            return False
        if self.direct and block.ctypes.data % 4096 != 0:
            # an O_DIRECT store needs page-aligned sources for the
            # zero-copy pwrite. False means NOTHING was written; note
            # the caller (MultiscaleWriter.write_level_block) treats any
            # refusal as a mixing hazard and routes the level to
            # tensorstore for good — satisfy the alignment contract to
            # stay on the raw path
            return False
        flat = block.reshape(-1).view(np.uint8).data  # zero-copy bytes
        for j, ry0 in enumerate(range(0, rows, cy)):
            nrows = min(cy, rows - ry0)
            nbytes = nrows * self.pitch
            byte0 = ry0 * self.pitch
            fpath = self._chunk_file(t, c, z, y0 // cy + j, cxi)
            fd, _ = self._open_chunk(fpath)
            try:
                if nrows < cy and os.fstat(fd).st_size < self.chunk_bytes:
                    # bottom-band partial chunk row: sparse-extend so
                    # untouched rows read as fill zeros
                    os.ftruncate(fd, self.chunk_bytes)
                done = 0
                while done < nbytes:
                    done += os.pwrite(fd, flat[byte0 + done:byte0 + nbytes],
                                      done)
            finally:
                os.close(fd)
        return True


class RawV3ShardWriter(_RawSlabWriterBase):
    """Writes band slabs into a raw (codecs: bytes-only) zarr v3
    sharding_indexed array's shard files directly.

    Shard layout (verified against tensorstore's output): concatenated
    fixed-size inner-chunk bodies in C-order, then a uint64-LE
    (offset, nbytes) index entry per nominal inner chunk, then the
    CRC-32C of the index, at the end of the file. With the raw 'bytes'
    codec every body is exactly chunk_nbytes, so all offsets are known
    up front: a shard file is created sparse at its full size with the
    index written once (every in-array chunk marked present; never-
    written bodies read as fill zeros — semantically identical to
    tensorstore's missing-chunk encoding, byte-identical whenever the
    slabs actually cover the shard), and band rows land via the same
    pwritev kernel as the v2 writer. Fill must be 0.

    Like RawV2SlabWriter, ``try_write`` returns False for any pattern
    outside the fusers' band-slab shape and the caller falls back to
    tensorstore, and the first fallback disables the writer for the
    level (``disable_on_fallback``): a tensorstore write to a v3 array
    repacks shard bodies in its own layout that later raw writes would
    corrupt.
    """

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], shard: Sequence[int], dtype,
                 fill_value=0, direct_io: str = 'auto'):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.shard = tuple(int(s) for s in shard)
        self.dtype = np.dtype(dtype)
        es = self.dtype.itemsize
        self.ok = (fill_value == 0 and len(self.shape) == 5
                   # body ordinals and chunk_nbytes assume one (t,c,z)
                   # plane per inner chunk AND per shard (creator layout)
                   # — a leading extent > 1 would mis-size every body
                   and self.chunks[:3] == (1, 1, 1)
                   and self.shard[:3] == self.chunks[:3])
        cy, cx = self.chunks[3], self.chunks[4]
        self.pitch = cx * es
        self.chunk_nbytes = cy * self.pitch
        # nominal inner grid per shard (ceil), C-order linearized
        self.inner = tuple(-(-self.shard[i] // self.chunks[i])
                           for i in range(5))
        self.n_inner = int(np.prod(self.inner))
        self._pad = ctypes.create_string_buffer(self.pitch)
        self._made_dirs = set()
        # body write offsets are ordinal*chunk_nbytes + k*pitch: both
        # must be block-aligned (the index write uses a plain fd)
        self._init_direct(direct_io if self.ok else 'off',
                          self.pitch, self.chunk_nbytes)

    # ------------------------------------------------------------------

    def _present_ordinals(self, sy: int, sx: int):
        """lin -> body ordinal for inner chunks whose origin lies inside
        the array; bodies are packed compactly in C-order (matching
        tensorstore's layout for fully-covered shards — out-of-array
        chunks occupy no body space)."""
        ordinals = {}
        lin = 0
        for iy in range(self.inner[3]):
            for ix in range(self.inner[4]):
                # leading inner axes are always singleton (checked)
                y0 = sy * self.shard[3] + iy * self.chunks[3]
                x0 = sx * self.shard[4] + ix * self.chunks[4]
                if y0 < self.shape[3] and x0 < self.shape[4]:
                    ordinals[lin] = len(ordinals)
                lin += 1
        return ordinals

    def _shard_sizes(self, ordinals):
        index_offset = len(ordinals) * self.chunk_nbytes
        return index_offset, index_offset + 16 * self.n_inner + 4

    def _shard_index_bytes(self, ordinals) -> bytes:
        entries = []
        for lin in range(self.n_inner):
            if lin in ordinals:
                entries.append((ordinals[lin] * self.chunk_nbytes,
                                self.chunk_nbytes))
            else:
                entries.append((0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF))
        raw = b''.join(struct.pack('<QQ', off, n) for off, n in entries)
        return raw + struct.pack('<I', crc32c(raw))

    def _shard_file(self, t: int, c: int, z: int, sy: int, sx: int) -> str:
        d = os.path.join(self.path, 'c', str(t), str(c), str(z), str(sy))
        if d not in self._made_dirs:
            os.makedirs(d, exist_ok=True)
            self._made_dirs.add(d)
        return os.path.join(d, str(sx))

    def _ensure_shard(self, fd: int, ordinals) -> None:
        index_offset, total_size = self._shard_sizes(ordinals)
        if os.fstat(fd).st_size >= total_size:
            return
        os.ftruncate(fd, total_size)
        # idempotent: concurrent creators write identical bytes.
        # A short pwrite would leave a truncated index with a bad CRC —
        # retry the remainder like the C side does.
        idx = self._shard_index_bytes(ordinals)
        done = 0
        while done < len(idx):
            done += os.pwrite(fd, idx[done:], index_offset + done)

    def _write_plane_slab(self, t: int, c: int, z: int, y0: int,
                          plane: np.ndarray) -> None:
        cy, cx = self.chunks[3], self.chunks[4]
        sy_rows, sx_cols = self.shard[3], self.shard[4]
        es = self.dtype.itemsize
        h, w = plane.shape
        y1 = y0 + h
        for syi in range(y0 // sy_rows, (y1 - 1) // sy_rows + 1):
            for sxi in range((w - 1) // sx_cols + 1):
                fpath = self._shard_file(t, c, z, syi, sxi)
                ordinals = self._present_ordinals(syi, sxi)
                if self.direct:
                    # the index write is byte-grained: create/extend the
                    # shard through a plain fd, then write bodies direct
                    pfd = os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644)
                    try:
                        self._ensure_shard(pfd, ordinals)
                    finally:
                        os.close(pfd)
                fd, is_direct = self._open_chunk(fpath)
                try:
                    if not is_direct:
                        self._ensure_shard(fd, ordinals)
                    # inner chunks of this shard intersecting the slab
                    cy0_base = syi * sy_rows
                    cx0_base = sxi * sx_cols
                    for iy in range(self.inner[3]):
                        gy0 = cy0_base + iy * cy
                        ry0, ry1 = max(y0, gy0), min(y1, gy0 + cy)
                        if ry1 <= ry0:
                            continue
                        for ix in range(self.inner[4]):
                            gx0 = cx0_base + ix * cx
                            rx1 = min(w, gx0 + cx)
                            if rx1 <= gx0:
                                continue
                            lin = iy * self.inner[4] + ix
                            row_bytes = (rx1 - gx0) * es
                            off0 = (ordinals[lin] * self.chunk_nbytes
                                    + (ry0 - gy0) * self.pitch)
                            self._pwrite_rows(
                                fd, plane, ry0 - y0, gx0, ry1 - ry0,
                                row_bytes, self.pitch - row_bytes,
                                off0, fpath, is_direct)
                finally:
                    os.close(fd)

    # -------------------------------------------------- chunk-block API

    def block_spec(self):
        """(chunk_rows, chunk_cols) when this writer accepts chunk-
        contiguous block writes (see RawV2SlabWriter.block_spec); shard
        bodies are fixed-size at known ordinals, so a block lands as one
        contiguous pwrite into its shard file."""
        return (self.chunks[3], self.chunks[4]) if self.ok else None

    def try_write_block(self, t: int, c: int, z: int, y0: int,
                        cxi: int, block: np.ndarray) -> bool:
        """v3 twin of RawV2SlabWriter.try_write_block — same contract
        (C-contiguous (rows, chunk_cols) block, chunk-row-aligned y0,
        pad columns already zero), same refusal semantics."""
        if not self.ok:
            return False
        cy, cx = self.chunks[3], self.chunks[4]
        rows = block.shape[0]
        if (block.dtype != self.dtype or block.ndim != 2
                or block.shape[1] != cx
                or not block.flags.c_contiguous
                or y0 % cy != 0 or rows <= 0
                or y0 + rows > self.shape[3]
                or cxi < 0 or cxi >= -(-self.shape[4] // cx)):
            return False
        if self.direct and block.ctypes.data % 4096 != 0:
            return False
        sy_rows, sx_cols = self.shard[3], self.shard[4]
        gx0 = cxi * cx
        sxi = gx0 // sx_cols
        ix = (gx0 - sxi * sx_cols) // cx
        flat = block.reshape(-1).view(np.uint8).data  # zero-copy bytes
        for ry0 in range(0, rows, cy):
            nrows = min(cy, rows - ry0)
            gy0 = y0 + ry0
            syi = gy0 // sy_rows
            iy = (gy0 - syi * sy_rows) // cy
            lin = iy * self.inner[4] + ix
            fpath = self._shard_file(t, c, z, syi, sxi)
            ordinals = self._present_ordinals(syi, sxi)
            if self.direct:
                # the index write is byte-grained: create/extend the
                # shard through a plain fd, then write the body direct
                pfd = os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644)
                try:
                    self._ensure_shard(pfd, ordinals)
                finally:
                    os.close(pfd)
            fd, is_direct = self._open_chunk(fpath)
            try:
                if not is_direct:
                    self._ensure_shard(fd, ordinals)
                off0 = ordinals[lin] * self.chunk_nbytes
                nbytes = nrows * self.pitch
                byte0 = ry0 * self.pitch
                done = 0
                while done < nbytes:
                    done += os.pwrite(fd, flat[byte0 + done:byte0 + nbytes],
                                      off0 + done)
            finally:
                os.close(fd)
        return True
