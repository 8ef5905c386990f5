"""OME-Zarr v0.4 writer: multiscales, OMERO, and HCS plate/well metadata.

Metadata trees structurally match what the reference emits through
ome-zarr-py (stitcher.py:771-859 multiscales+omero; :1008-1218 plate/well)
— same keys, same values, same axis definitions — written directly as
JSON so the output is fully under our control.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .zarr_store import (create_raw_zarr_array, create_zarr3_sharded_array,
                         create_zarr_array, write_group)

# Axis definitions, parity with reference stitcher.py:825-831.
OME_AXES = [
    {"name": "t", "type": "time", "unit": "second"},
    {"name": "c", "type": "channel"},
    {"name": "z", "type": "space", "unit": "micrometer"},
    {"name": "y", "type": "space", "unit": "micrometer"},
    {"name": "x", "type": "space", "unit": "micrometer"},
]


def dataset_transforms(num_levels: int, dz_um: float, pixel_size_um: float) -> List[Dict]:
    """Per-level scale transforms [1, 1, dz, px*2^l, px*2^l]
    (reference stitcher.py:801-813)."""
    return [
        {
            "path": str(level),
            "coordinateTransformations": [{
                "type": "scale",
                "scale": [1, 1, float(dz_um),
                          float(pixel_size_um * (2 ** level)),
                          float(pixel_size_um * (2 ** level))],
            }],
        }
        for level in range(num_levels)
    ]


def multiscales_attrs(name: str, num_levels: int, dz_um: float,
                      pixel_size_um: float) -> Dict:
    return {
        "multiscales": [{
            "axes": OME_AXES,
            "datasets": dataset_transforms(num_levels, dz_um, pixel_size_um),
            "name": name,
            "version": "0.4",
        }]
    }


def ngff05_wrap(**members) -> Dict:
    """OME-NGFF 0.5 group attributes: everything under one 'ome' key
    with a group-level version (zarr v3 stores; RFC-2 layout)."""
    return {"ome": {"version": "0.5", **members}}


def multiscales_attrs_v3(name: str, num_levels: int, dz_um: float,
                         pixel_size_um: float,
                         omero: Optional[Dict] = None) -> Dict:
    """NGFF 0.5 multiscales: same axes/datasets/transform trees as 0.4,
    but nested under 'ome' without per-multiscale version keys."""
    ms = {
        "axes": OME_AXES,
        "datasets": dataset_transforms(num_levels, dz_um, pixel_size_um),
        "name": name,
    }
    members = {"multiscales": [ms]}
    if omero is not None:
        omero = {k: v for k, v in omero.items() if k != 'version'}
        members["omero"] = omero
    return ngff05_wrap(**members)


def omero_attrs(name: str, channel_names: Sequence[str],
                channel_colors: Sequence[int], dtype,
                full: bool = True) -> Dict:
    """OMERO display metadata (reference stitcher.py:839-856; the merge
    paths write a reduced window dict, stitcher.py:955-963 -> full=False)."""
    if np.issubdtype(np.dtype(dtype), np.integer):
        lo, hi = int(np.iinfo(np.dtype(dtype)).min), int(np.iinfo(np.dtype(dtype)).max)
    else:
        lo, hi = 0, 1
    channels = []
    for cname, color in zip(channel_names, channel_colors):
        ch = {
            "label": cname,
            "color": f"{color:06X}",
            "window": ({"start": 0, "end": hi, "min": lo, "max": hi}
                       if full else {"start": 0, "end": hi}),
        }
        if full:
            ch.update({"active": True, "coefficient": 1, "family": "linear"})
        channels.append(ch)
    omero = {"name": name, "version": "0.4", "channels": channels}
    if full:
        omero["id"] = 1
    return omero


def plate_attrs(regions: Sequence[str], name: str, acquisition_name: str) -> Dict:
    """HCS plate metadata: rows = region[0], columns = region[1:]
    (reference stitcher.py:1017-1036)."""
    rows = sorted({r[0] for r in regions})
    columns = sorted({str(r[1:]) for r in regions})
    wells = []
    for well_id in sorted(regions):
        row, col = well_id[0], well_id[1:]
        wells.append({
            "path": f"{row}/{col}",
            "rowIndex": rows.index(row),
            "columnIndex": columns.index(str(col)),
        })
    return {
        "plate": {
            "acquisitions": [{"id": 0, "maximumfieldcount": 1,
                              "name": acquisition_name}],
            "columns": [{"name": c} for c in columns],
            "field_count": 1,
            "name": name,
            "rows": [{"name": r} for r in rows],
            "version": "0.4",
            "wells": wells,
        }
    }


def well_attrs() -> Dict:
    """Well group metadata (reference stitcher.py:1059-1062)."""
    return {"well": {"images": [{"path": "0", "acquisition": 0}],
                     "version": "0.4"}}


#: default async-write backpressure window; concurrent merge writers
#: split this so a merge phase's pending-bytes ceiling equals one
#: sequential writer's (models/merge._make_image_writer divides it)
DEFAULT_MAX_PENDING_BYTES = 512 << 20


class MultiscaleWriter:
    """Streams one multiscale OME-Zarr image group level by level.

    Usage: construct, then write_level(level, array or slabs), then close().
    Level arrays are created eagerly so slab writes can land async.
    """

    def __init__(self, path: str, base_shape: Sequence[int],
                 num_levels: int, dtype, chunks: Sequence[int],
                 name: str, dz_um: float, pixel_size_um: float,
                 channel_names: Sequence[str], channel_colors: Sequence[int],
                 cname: str = 'zstd', clevel: int = 1, shuffle: int = 1,
                 omero_full: bool = True, write_omero: bool = True,
                 max_pending_bytes: int = None,
                 zarr_format: int = 2, shard_multiple: int = 16,
                 direct_io: str = 'auto'):
        from ..ops.pyramid import level_shapes
        self.path = path
        self.num_levels = num_levels
        self.shapes = level_shapes(tuple(base_shape), num_levels)
        self._raw = None  # direct raw-chunk writers (set below when raw)
        # raw v2 levels have no tensorstore array to fall back to: a slab
        # the raw writer refuses is an error there
        self._raw_only = False
        omero = (omero_attrs(name, channel_names, channel_colors, dtype,
                             full=omero_full) if write_omero else None)
        if zarr_format == 3:
            # OME-NGFF 0.5 on zarr v3: attrs under 'ome' in zarr.json,
            # levels as sharding_indexed arrays (~10x fewer files)
            attrs = multiscales_attrs_v3(name, num_levels, dz_um,
                                         pixel_size_um, omero=omero)
            write_group(path, attrs, zarr_format=3)
            self.arrays = [
                create_zarr3_sharded_array(
                    os.path.join(path, str(level)), self.shapes[level],
                    chunks, dtype, shard_multiple=shard_multiple,
                    cname=cname, clevel=clevel)
                for level in range(num_levels)
            ]
            if cname is None:
                # raw inner chunks: band slabs go straight into shard
                # files (bodies at deterministic offsets + fixed index)
                from .raw_zarr import RawV3ShardWriter
                from .zarr_store import compute_shard_shape
                self._raw = []
                for level in range(num_levels):
                    cl, sh = compute_shard_shape(self.shapes[level],
                                                 chunks, shard_multiple)
                    self._raw.append(RawV3ShardWriter(
                        os.path.join(path, str(level)),
                        self.shapes[level], cl, sh, dtype,
                        direct_io=direct_io))
        else:
            attrs = multiscales_attrs(name, num_levels, dz_um, pixel_size_um)
            if omero is not None:
                attrs["omero"] = omero
            write_group(path, attrs)
            raw = None
            if cname is None:
                # raw chunks: band slabs go straight to chunk files via
                # pwritev (io/raw_zarr.py), and every level is written
                # only there — no tensorstore on this path
                from .raw_zarr import RawV2SlabWriter
                raw = [RawV2SlabWriter(os.path.join(path, str(level)),
                                       self.shapes[level], chunks, dtype,
                                       direct_io=direct_io)
                       for level in range(num_levels)]
            if raw is not None and all(r.ok for r in raw):
                for level in range(num_levels):
                    create_raw_zarr_array(os.path.join(path, str(level)),
                                          self.shapes[level], chunks, dtype)
                self._raw = raw
                self._raw_only = True
                self.arrays = None
            else:
                self.arrays = [
                    create_zarr_array(os.path.join(path, str(level)),
                                      self.shapes[level], chunks, dtype,
                                      cname=cname, clevel=clevel,
                                      shuffle=shuffle)
                    for level in range(num_levels)
                ]
        self._pending = []          # (future, nbytes) in issue order
        self._pending_bytes = 0
        self._max_pending_bytes = (DEFAULT_MAX_PENDING_BYTES
                                   if max_pending_bytes is None
                                   else max_pending_bytes)
        import threading
        self._lock = threading.Lock()

    def block_spec(self, level: int = 0):
        """(chunk_rows, chunk_cols) when ``level`` accepts chunk-
        contiguous block writes (raw v2 path), else None. A chunk-
        column-blocked band fuser then writes each chunk file with one
        contiguous pwrite — no row gather, no staging pack."""
        if self._raw is None:
            return None
        raw = self._raw[level]
        spec = getattr(raw, 'block_spec', None)
        return spec() if spec is not None else None

    def write_level_block(self, level: int, c: int, z: int, y0: int,
                          cxi: int, block: np.ndarray) -> bool:
        """Write one chunk-column block (see RawV2SlabWriter.
        try_write_block). Falls back to a tensorstore slab write of the
        in-canvas columns when the raw path refuses.

        Returns True when ``block`` was consumed before returning (the
        caller may reuse the buffer), False when tensorstore still
        references it."""
        raw = self._raw[level] if self._raw is not None else None
        if raw is not None and getattr(raw, 'try_write_block', None):
            if raw.try_write_block(0, c, z, y0, cxi, block):
                return True
            if self._raw_only:
                self._refused(level, f"chunk block {block.shape} at "
                                     f"(c={c}, z={z}, y0={y0}, cx={cxi})")
            if raw.disable_on_fallback:
                # conservative: once anything in this level goes through
                # tensorstore, later raw zero-padding writes could clobber
                # it — same mixing gate as the row path. Callers honoring
                # try_write_block's contract never trip this.
                raw.ok = False
        cx = block.shape[1]
        w = self.shapes[level][4]
        x0 = cxi * cx
        x1 = min(x0 + cx, w)
        sel = (slice(0, 1), slice(c, c + 1), slice(z, z + 1),
               slice(y0, y0 + block.shape[0]), slice(x0, x1))
        return self.write_level(level, block[None, None, None, :, :x1 - x0],
                                sel=sel)

    def write_level(self, level: int, data: np.ndarray, sel: Optional[Tuple] = None,
                    block: bool = False) -> bool:
        """Write a full level or a slab (sel = tuple of slices).

        Writes land asynchronously (tensorstore compresses + commits on
        its own executor) with backpressure: once ``max_pending_bytes``
        of slabs are in flight, the oldest futures are drained first so
        bounded-memory streaming stays bounded end to end.

        Returns True when ``data`` was fully consumed before returning
        (the raw synchronous path, or block=True) — the caller may then
        reuse the buffer; False means the writer still references it.
        """
        if self._raw is not None:
            raw = self._raw[level]
            if raw.try_write(sel, data):
                return True
            if self._raw_only:
                self._refused(level, f"slab {np.shape(data)} at {sel}")
            # mixing gate (v3): one fallback disables raw for this level
            # for good — tensorstore repacks shard bodies in write-order
            # subset layout, which later raw writes would corrupt. The
            # fusers' patterns are uniform per level, so if one slab
            # falls back they all would — disabling costs nothing.
            if raw.disable_on_fallback:
                raw.ok = False
        target = self.arrays[level] if sel is None else self.arrays[level][sel]
        fut = target.write(data)
        if block:
            fut.result()
            return True
        drain = []
        with self._lock:
            self._pending.append((fut, data.nbytes))
            self._pending_bytes += data.nbytes
            while self._pending_bytes > self._max_pending_bytes and self._pending:
                old, nbytes = self._pending.pop(0)
                self._pending_bytes -= nbytes
                drain.append(old)
        for old in drain:
            old.result()
        return False

    def _refused(self, level: int, what: str):
        raise ValueError(
            f"raw zarr v2 writer for level {level} of {self.path} cannot "
            f"write {what}: only full-width row slabs and chunk-column "
            "blocks are supported without a compressor")

    def close(self):
        with self._lock:
            pending, self._pending = self._pending, []
            self._pending_bytes = 0
        for fut, _ in pending:
            fut.result()
