"""Tile -> canvas fusion ops (jitted, device-resident).

Replaces the reference's per-tile host-side slice assignment
(stitcher.py:563-605 place_single_channel_tile) with batched on-device
placement. Semantics parity notes:

- 'overwrite': later tile wins, masked regions keep prior canvas value —
  bit-identical to the reference's direct slice writes with edge crops
  (crops become masks; positions stay pre-crop, which is equivalent since
  the reference adds the crop offsets back, stitcher.py:585-587).
- Canvas-edge clamping (stitcher.py:589-594) is handled by fusing into a
  canvas padded by one tile extent on bottom/right; overflow lands in the
  pad and is discarded at finalize.
- 'feather': weighted-ramp blending in overlap zones — an upgrade the
  reference does not have (SURVEY.md §0: no feathering exists upstream).

All shapes are static: tiles arrive in fixed-size batches (N, th, tw) with
a validity flag per tile, so one compiled program serves the whole run.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def padded_canvas_shape(num_c: int, num_z: int, height: int, width: int,
                        tile_h: int, tile_w: int) -> Tuple[int, int, int, int]:
    """Canvas allocated with a one-tile apron on bottom/right so every
    dynamic_update_slice is in-bounds without per-tile clamping."""
    return (num_c, num_z, height + tile_h, width + tile_w)


def _tile_mask(crops: jnp.ndarray, tile_h: int, tile_w: int,
               valid: jnp.ndarray) -> jnp.ndarray:
    """(th, tw) bool mask keeping rows [top, th-bottom) x cols [left, tw-right)."""
    top, bottom, left, right = crops[0], crops[1], crops[2], crops[3]
    rows = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    mask = ((rows >= top) & (rows < tile_h - bottom)
            & (cols >= left) & (cols < tile_w - right))
    return mask & valid


@functools.partial(jax.jit, donate_argnums=(0,))
def fuse_overwrite(canvas: jnp.ndarray, tiles: jnp.ndarray,
                   info: jnp.ndarray, crops: jnp.ndarray,
                   valid: jnp.ndarray) -> jnp.ndarray:
    """Place a batch of tiles into the padded canvas, overwrite semantics.

    Args:
      canvas: (C, Z, Hp, Wp) native dtype, padded (see padded_canvas_shape).
      tiles:  (N, th, tw) native dtype.
      info:   (N, 4) int32 [channel, z, y, x] — y/x pre-crop top-left.
      crops:  (N, 4) int32 [top, bottom, left, right] masked-out margins.
      valid:  (N,) bool — False entries are no-ops (batch padding).

    Returns the updated canvas. Tiles apply in batch order, so reference
    iteration order (sorted tile index) is preserved across batches.
    """
    tile_h, tile_w = tiles.shape[1], tiles.shape[2]

    def body(cv, inp):
        tile, meta, crop, ok = inp
        c, z, y, x = meta[0], meta[1], meta[2], meta[3]
        mask = _tile_mask(crop, tile_h, tile_w, ok)
        current = jax.lax.dynamic_slice(cv, (c, z, y, x), (1, 1, tile_h, tile_w))
        updated = jnp.where(mask[None, None], tile[None, None], current)
        cv = jax.lax.dynamic_update_slice(cv, updated, (c, z, y, x))
        return cv, None

    canvas, _ = jax.lax.scan(body, canvas, (tiles, info, crops, valid))
    return canvas


def _feather_ramp(crops: jnp.ndarray, tile_h: int, tile_w: int,
                  valid: jnp.ndarray, blend_px: int) -> jnp.ndarray:
    """Separable linear ramp rising from the (cropped) tile border inward,
    saturating after ``blend_px`` pixels. Zero outside the valid window."""
    top, bottom, left, right = crops[0], crops[1], crops[2], crops[3]
    rows = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    d_top = rows - top + 1
    d_bot = (tile_h - bottom) - rows
    d_left = cols - left + 1
    d_right = (tile_w - right) - cols
    d = jnp.minimum(jnp.minimum(d_top, d_bot), jnp.minimum(d_left, d_right))
    w = jnp.clip(d.astype(jnp.float32) / float(blend_px), 0.0, 1.0)
    return jnp.where((d > 0) & valid, w, 0.0)


@functools.partial(jax.jit, static_argnames=('blend_px',), donate_argnums=(0, 1))
def fuse_feather(acc: jnp.ndarray, wsum: jnp.ndarray, tiles: jnp.ndarray,
                 info: jnp.ndarray, crops: jnp.ndarray, valid: jnp.ndarray,
                 blend_px: int = 64) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate weighted tiles: acc += w*tile, wsum += w (f32 canvases)."""
    tile_h, tile_w = tiles.shape[1], tiles.shape[2]

    def body(carry, inp):
        a, w = carry
        tile, meta, crop, ok = inp
        c, z, y, x = meta[0], meta[1], meta[2], meta[3]
        ramp = _feather_ramp(crop, tile_h, tile_w, ok, blend_px)
        cur_a = jax.lax.dynamic_slice(a, (c, z, y, x), (1, 1, tile_h, tile_w))
        cur_w = jax.lax.dynamic_slice(w, (c, z, y, x), (1, 1, tile_h, tile_w))
        new_a = cur_a + (ramp * tile.astype(jnp.float32))[None, None]
        new_w = cur_w + ramp[None, None]
        a = jax.lax.dynamic_update_slice(a, new_a, (c, z, y, x))
        w = jax.lax.dynamic_update_slice(w, new_w, (c, z, y, x))
        return (a, w), None

    (acc, wsum), _ = jax.lax.scan(body, (acc, wsum), (tiles, info, crops, valid))
    return acc, wsum


@functools.partial(jax.jit, static_argnames=('out_dtype',))
def finalize_feather(acc: jnp.ndarray, wsum: jnp.ndarray, out_dtype=jnp.uint16):
    """acc / wsum, zeros where nothing landed, cast back to output dtype."""
    out = acc / jnp.maximum(wsum, 1e-6)
    out = jnp.where(wsum > 0, out, 0.0)
    info = np.iinfo(np.dtype(out_dtype)) if np.issubdtype(np.dtype(out_dtype), np.integer) else None
    if info is not None:
        out = jnp.clip(jnp.round(out), info.min, info.max)
    return out.astype(out_dtype)


@functools.partial(jax.jit, static_argnames=('out_dtype',))
def apply_flatfield(tiles: jnp.ndarray, ff_recip: jnp.ndarray,
                    channel_idx: jnp.ndarray, out_dtype=jnp.uint16) -> jnp.ndarray:
    """Per-tile flatfield correct-clip-cast (reference stitcher.py:607-611).

    tiles: (N, th, tw); ff_recip: (C, th, tw) f32 RECIPROCAL flatfields
    (ones where absent); channel_idx: (N,) int32.

    The correction multiplies by a HOST-computed reciprocal instead of
    dividing: an f32 product is correctly rounded on every backend,
    while a device divide may be lowered to a reciprocal approximation
    that differs from the host's IEEE divide in the last bit — enough to
    flip a uint16 truncation. One reciprocal computed once on the host
    keeps the host and device paths byte-identical (checked on the GPU
    by chip_smoke.py).
    """
    ff = jnp.take(ff_recip, channel_idx, axis=0)  # (N, th, tw)
    corrected = tiles.astype(jnp.float32) * ff
    info = np.iinfo(np.dtype(out_dtype)) if np.issubdtype(np.dtype(out_dtype), np.integer) else None
    if info is not None:
        corrected = jnp.clip(corrected, info.min, info.max)
    return corrected.astype(out_dtype)
