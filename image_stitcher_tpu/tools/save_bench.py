#!/usr/bin/env python3
"""Save-method benchmark harness: time/size writer x chunk combinations.

Counterpart of the reference's only test apparatus, save_region_test.py
(stitcher_process.py writers bake-off, save_region_test.py:1-183):
generates synthetic uint16 TCZYX volumes and sweeps writer backends x
chunk sizes, reporting seconds and MB on disk.

Writers swept here: tensorstore OME-Zarr (ours), pyramidal OME-TIFF
(ours), and zlib-chunk files (the no-framework floor).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import zlib
from typing import Dict, List

import numpy as np


def du_mb(path: str) -> float:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    if os.path.isfile(path):
        total = os.path.getsize(path)
    return total / 1e6


def _write_ome_zarr_impl(volume: np.ndarray, out: str, chunk: int,
                         cname='zstd', zarr_format: int = 2,
                         native: bool = True) -> None:
    """MultiscaleWriter with selectable compressor/format, and the
    native raw-chunk writer optionally disabled to isolate its effect
    (cname=None + native=False forces the tensorstore raw path)."""
    from .. import native as nat
    from ..io.omezarr import MultiscaleWriter
    saved = (nat._LIB, nat._TRIED) if not native else None
    if not native:
        nat._LIB, nat._TRIED = None, True
    try:
        t, c, z, h, w = volume.shape
        writer = MultiscaleWriter(out, volume.shape, 1, volume.dtype,
                                  (1, 1, 1, chunk, chunk), "bench",
                                  1.0, 1.0,
                                  [f"ch{i}" for i in range(c)],
                                  [0xFFFFFF] * c, cname=cname,
                                  zarr_format=zarr_format)
        writer.write_level(0, volume)
        writer.close()
    finally:
        if saved is not None:
            nat._LIB, nat._TRIED = saved


def write_ome_zarr(volume: np.ndarray, out: str, chunk: int) -> None:
    _write_ome_zarr_impl(volume, out, chunk)


def write_ome_tiff(volume: np.ndarray, out: str, chunk: int,
                   compression: str = 'deflate') -> None:
    from ..io.tiffwriter import write_ome_tiff_pyramid
    if compression == 'jpeg' and volume.dtype != np.uint8:
        volume = (volume >> 8).astype(np.uint8)  # jpeg is 8-bit only
    write_ome_tiff_pyramid(out, [volume[0]], "bench",
                           [f"ch{i}" for i in range(volume.shape[1])],
                           [0xFFFFFF] * volume.shape[1], 1.0, 1.0,
                           compression=compression)


def write_raw_chunks(volume: np.ndarray, out: str, chunk: int) -> None:
    os.makedirs(out, exist_ok=True)
    t, c, z, h, w = volume.shape
    for ci in range(c):
        for zi in range(z):
            for y in range(0, h, chunk):
                for x in range(0, w, chunk):
                    blob = zlib.compress(np.ascontiguousarray(
                        volume[0, ci, zi, y:y + chunk, x:x + chunk]).tobytes(), 1)
                    with open(os.path.join(out, f"{ci}.{zi}.{y}.{x}"), "wb") as f:
                        f.write(blob)


def write_zarr3_sharded(volume: np.ndarray, out: str, chunk: int) -> None:
    from ..io.zarr_store import create_zarr3_sharded_array
    arr = create_zarr3_sharded_array(out, volume.shape,
                                     (1, 1, 1, chunk, chunk), volume.dtype)
    arr.write(volume).result()


def count_files(path: str) -> int:
    return sum(len(fs) for _, _, fs in os.walk(path)) if os.path.isdir(path) else 1


WRITERS = {
    "ome_zarr_tensorstore": (write_ome_zarr, ".ome.zarr"),
    "zarr3_sharded": (write_zarr3_sharded, ".zarr"),
    "ome_tiff_pyramidal": (write_ome_tiff, ".ome.tiff"),
    # TIFF codec A/B rows (VERDICT r4 #6): deflate (our default) vs raw
    # vs jpeg (the reference's pyvips production default; uint16 input
    # is >>8'd to uint8 first — jpeg is 8-bit only)
    "tiff_raw": (
        lambda v, o, c: write_ome_tiff(v, o, c, compression='raw'),
        ".ome.tiff"),
    "tiff_jpeg": (
        lambda v, o, c: write_ome_tiff(v, o, c, compression='jpeg'),
        ".ome.tiff"),
    "zlib_chunks": (write_raw_chunks, ".chunks"),
    # raw (compressor-null) rows: direct pwritev writer vs the same
    # store written through tensorstore — isolates io/raw_zarr.py
    "v2_raw_direct": (
        lambda v, o, c: _write_ome_zarr_impl(v, o, c, cname=None),
        ".ome.zarr"),
    "v2_raw_tensorstore": (
        lambda v, o, c: _write_ome_zarr_impl(v, o, c, cname=None,
                                             native=False),
        ".ome.zarr"),
    "v3_raw_direct": (
        lambda v, o, c: _write_ome_zarr_impl(v, o, c, cname=None,
                                             zarr_format=3),
        ".zarr"),
    "v3_raw_tensorstore": (
        lambda v, o, c: _write_ome_zarr_impl(v, o, c, cname=None,
                                             zarr_format=3, native=False),
        ".zarr"),
}


def measure(size: int, z: int, c: int, chunks: List[int],
            writers: List[str]) -> List[Dict]:
    rng = np.random.default_rng(0)
    print(f"generating ({1},{c},{z},{size},{size}) uint16...", file=sys.stderr)
    volume = rng.integers(0, 65535, (1, c, z, size, size), dtype=np.uint16)
    # untimed warmup: the first timed cell otherwise runs 3-8x slow on
    # this host (cold allocator/page state after the generation above),
    # which systematically penalizes whichever writer is listed first
    warm = os.path.join(tempfile.mkdtemp(prefix="save_bench_"), "warm")
    try:
        _write_ome_zarr_impl(volume[:, :1, :1, :2048, :2048], warm, 1024,
                             cname=None)
    except Exception:
        pass
    finally:
        shutil.rmtree(os.path.dirname(warm), ignore_errors=True)
    results = []
    for wname in writers:
        fn, suffix = WRITERS[wname]
        for chunk in chunks:
            out = os.path.join(tempfile.mkdtemp(prefix="save_bench_"),
                               f"vol{suffix}")
            t0 = time.perf_counter()
            try:
                fn(volume, out, chunk)
                dt = time.perf_counter() - t0
                nf = count_files(out)
                results.append({"writer": wname, "chunk": chunk,
                                "seconds": round(dt, 2),
                                "mb": round(du_mb(out), 1),
                                "files": nf,
                                "size": size})
                print(f"{wname:>24} chunk={chunk:<5} {dt:7.2f}s "
                      f"{du_mb(out):9.1f} MB {nf:6d} files", file=sys.stderr)
            except Exception as e:
                print(f"{wname} chunk={chunk} FAILED: {e}", file=sys.stderr)
            finally:
                shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Writer bake-off harness")
    p.add_argument("--sizes", type=int, nargs="+", default=[6000])
    p.add_argument("--z", type=int, default=2)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--chunks", type=int, nargs="+", default=[1024, 2048, 4096])
    # the raw direct-vs-tensorstore rows are opt-in: the default sweep
    # keeps the original four writers
    p.add_argument("--writers", nargs="+",
                   default=["ome_zarr_tensorstore", "zarr3_sharded",
                            "ome_tiff_pyramidal", "zlib_chunks"],
                   choices=list(WRITERS))
    p.add_argument("--json", action="store_true", help="print JSON results")
    args = p.parse_args(argv)
    all_results = []
    for size in args.sizes:
        all_results.extend(measure(size, args.z, args.channels, args.chunks,
                                   args.writers))
    if args.json:
        print(json.dumps(all_results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
