#!/usr/bin/env python3
"""Environment diagnosis: the first-hardware-contact checklist, automated.

``stitcher-doctor`` reports:

- the jax backend a run uses: platform, device kind and count, and for
  NVIDIA cards their name and power limit as ``nvidia-smi`` gives them
- the fusion backend ``fusion_device='auto'`` picks on that platform
- native C kernel availability (and which symbols are bound)
- disk write throughput where outputs would land
- persistent compile-cache state

Reference context: the reference has no diagnostics at all (prints
only); deployment triage there means reading tracebacks. This replaces
docs/DEPLOYMENT.md's manual checklist items with one command.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List


def gpu_name_and_power_limit() -> List[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card;
    empty when there is no NVIDIA driver on this host."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _check_device() -> List[str]:
    import jax
    devs = jax.devices()
    lines = [f"backend: platform={devs[0].platform} "
             f"kind={devs[0].device_kind} count={len(devs)}"]
    for card in gpu_name_and_power_limit():
        lines.append(f"card: {card}")
    from ..models.pipeline import auto_fusion_backend
    lines.append(f"fusion_device='auto' runs fusion on: "
                 f"{auto_fusion_backend()}")
    return lines


def _check_native() -> List[str]:
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return ["native kernels: UNAVAILABLE (no C compiler?) — host "
                "fusion and raw zarr writes fall back to NumPy"]
    syms = [s for s in ('place_u16', 'feather_u16', 'write_rows_contig',
                        'downsample2x_u16', 'downsample2x2_mean_u16')
            if hasattr(lib, s)]
    return [f"native kernels: OK ({', '.join(syms)})"]


def _check_disk(path: str, size_mb: int = 256) -> List[str]:
    buf = os.urandom(1 << 20)
    fd, tmp = tempfile.mkstemp(dir=path, prefix='.doctor_disk_')
    try:
        t0 = time.perf_counter()
        for _ in range(size_mb):
            os.write(fd, buf)
        os.fsync(fd)
        dt = time.perf_counter() - t0
    finally:
        os.close(fd)
        os.unlink(tmp)
    return [f"disk write ({path}): {size_mb / dt:.0f} MB/s "
            f"({size_mb} MB, fsync'd)"]


def _check_caches() -> List[str]:
    from .. import compile_cache_dir
    cc = compile_cache_dir()
    n = 0
    for _root, _dirs, files in os.walk(cc):
        n += len(files)
    return [f"jax compile cache: {n} file(s) under {cc}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diagnose the stitching environment")
    ap.add_argument("--output-dir", default=tempfile.gettempdir(),
                    help="directory whose disk to probe (default: tmp)")
    ap.add_argument("--skip-device", action="store_true",
                    help="do not initialize a jax backend")
    args = ap.parse_args(argv)

    sections = []
    if args.skip_device:
        sections.append(("Device", ["device: skipped"]))
    else:
        sections.append(("Device", _check_device()))
    sections.append(("Native", _check_native()))
    try:
        sections.append(("Disk", _check_disk(args.output_dir)))
    except OSError as e:
        sections.append(("Disk", [f"disk probe failed: {e}"]))
    sections.append(("Caches", _check_caches()))

    for title, lines in sections:
        print(f"[{title}]")
        for line in lines:
            print(f"  {line}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
