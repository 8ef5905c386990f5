"""Multiscale pyramid downsampling (jitted, level-from-level).

Two modes, both floor-dividing odd extents like the reference:
- 'nearest': stride-2 subsampling — parity with the reference zarr save
  path (ome_zarr Scaler.nearest, stitcher.py:797-798).
- 'mean': 2x2 box mean with excess trimmed — parity with the reference
  merge paths (da.coarsen(np.mean, trim_excess=True), stitcher.py:887-898).

Levels are built from the previous level (like zarr_stitcher.py:614-664),
never from the base, so a full pyramid costs ~1/3 extra bandwidth.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp


@jax.jit
def downsample_nearest(x: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 pick over the last two axes; output dims floor(n/2)."""
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    return x[..., :h2:2, :w2:2]


@jax.jit
def downsample_mean(x: jnp.ndarray) -> jnp.ndarray:
    """2x2 box mean over the last two axes, excess row/col trimmed.

    Matches np.mean coarsening: accumulate in f32, round back for ints.
    astype-from-float truncates TOWARD ZERO, so ints use trunc (floor
    would bias negative values of signed canvases by -1; identical for
    the unsigned microscopy dtypes) — exact parity with
    da.coarsen(np.mean).astype semantics.
    """
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    t = x[..., :h2, :w2]
    lead = t.shape[:-2]
    t = t.reshape(lead + (h2 // 2, 2, w2 // 2, 2)).astype(jnp.float32)
    m = t.mean(axis=(-3, -1))
    if jnp.issubdtype(x.dtype, jnp.integer):
        m = jnp.trunc(m)
    return m.astype(x.dtype)


def level_shapes(base_shape: Tuple[int, ...], num_levels: int) -> List[Tuple[int, ...]]:
    """Shapes of all pyramid levels; only the last two axes shrink."""
    shapes = [tuple(base_shape)]
    for _ in range(1, num_levels):
        prev = shapes[-1]
        shapes.append(prev[:-2] + (prev[-2] // 2, prev[-1] // 2))
    return shapes


def downsample(x: jnp.ndarray, mode: str) -> jnp.ndarray:
    if mode == 'nearest':
        return downsample_nearest(x)
    if mode == 'mean':
        return downsample_mean(x)
    raise ValueError(f"Unknown pyramid downsample mode: {mode}")


def iter_levels(canvas, num_levels: int, mode: str):
    """Yield pyramid levels level-from-level (level 0 = the input).

    One dispatch point for host (NumPy, via host_fuse.host_downsample)
    vs device (jitted downsample) canvases — the save and OME-TIFF
    paths share it so the two can never drift.
    """
    import numpy as np
    is_host = isinstance(canvas, np.ndarray)
    level = canvas
    for lv in range(num_levels):
        if lv > 0:
            if is_host:
                from .host_fuse import host_downsample
                level = host_downsample(level, mode)
            else:
                level = downsample(level, mode)
        yield level
