"""The device fusion kernels (ops/fuse.py, the XLA scan) against a plain
NumPy slice-assign reference.

The reference places tiles one at a time in batch order with basic
slicing — later tile wins, crops trimmed from each edge — exactly the
reference stitcher's placement (stitcher.py:563-605). Shapes cover the
production-like 64x64 tiles, unaligned camera extents, signed dtypes,
the flatfield correction and feathering; ``splits`` fuses the same
tiles in one call or across two consecutive calls (order must carry
across batches).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from image_stitcher_tpu.ops.fuse import (apply_flatfield, finalize_feather,
                                         fuse_feather, fuse_overwrite,
                                         padded_canvas_shape)


def _problem(rng, n=12, C=2, Z=1, H=96, W=80, th=32, tw=32):
    tiles = rng.integers(0, 65535, (n, th, tw), dtype=np.uint16)
    info = np.stack([
        rng.integers(0, C, n), rng.integers(0, Z, n),
        rng.integers(0, H, n), rng.integers(0, W, n)], axis=1).astype(np.int32)
    crops = rng.integers(0, 6, (n, 4)).astype(np.int32)
    valid = rng.random(n) > 0.2
    return tiles, info, crops, valid


def correct_ref(tiles, ff, channels, dtype):
    """Flatfield reference: multiply by the reciprocal, clip, truncate."""
    lim = np.iinfo(dtype)
    out = tiles.astype(np.float32) * ff[channels]
    return np.clip(out, lim.min, lim.max).astype(dtype)


def overwrite_ref(C, Z, H, W, tiles, info, crops, valid, dtype=np.uint16):
    """Slice-assign each valid tile's cropped window, in order."""
    n, th, tw = tiles.shape
    canvas = np.zeros(padded_canvas_shape(C, Z, H, W, th, tw), dtype)
    for t, (c, z, y, x), (top, bottom, left, right), ok in zip(
            tiles, info, crops, valid):
        if ok:
            canvas[c, z, y + top:y + th - bottom, x + left:x + tw - right] = \
                t[top:th - bottom, left:tw - right]
    return canvas[:, :, :H, :W]


def feather_ref(C, Z, H, W, tiles, info, crops, valid, blend_px,
                dtype=np.uint16):
    """Weighted-ramp accumulation + normalize, in float32."""
    n, th, tw = tiles.shape
    shp = padded_canvas_shape(C, Z, H, W, th, tw)
    acc = np.zeros(shp, np.float32)
    wsum = np.zeros(shp, np.float32)
    rows = np.arange(th)[:, None]
    cols = np.arange(tw)[None, :]
    for t, (c, z, y, x), (top, bottom, left, right), ok in zip(
            tiles, info, crops, valid):
        if not ok:
            continue
        d = np.minimum(np.minimum(rows - top + 1, (th - bottom) - rows),
                       np.minimum(cols - left + 1, (tw - right) - cols))
        w = np.clip(d.astype(np.float32) / np.float32(blend_px), 0, 1)
        w = np.where(d > 0, w, np.float32(0))
        acc[c, z, y:y + th, x:x + tw] += w * t.astype(np.float32)
        wsum[c, z, y:y + th, x:x + tw] += w
    out = np.where(wsum > 0, acc / np.maximum(wsum, 1e-6), 0)
    lim = np.iinfo(dtype)
    out = np.clip(np.round(out), lim.min, lim.max).astype(dtype)
    return out[:, :, :H, :W]


def _fuse_overwrite(C, Z, H, W, tiles, info, crops, valid, splits=1,
                    dtype=np.uint16):
    th, tw = tiles.shape[1:]
    cv = jnp.zeros(padded_canvas_shape(C, Z, H, W, th, tw), dtype)
    for part in np.array_split(np.arange(len(tiles)), splits):
        cv = fuse_overwrite(cv, jnp.asarray(tiles[part]),
                            jnp.asarray(info[part]), jnp.asarray(crops[part]),
                            jnp.asarray(valid[part]))
    return np.asarray(cv)[:, :, :H, :W]


def _fuse_feather(C, Z, H, W, tiles, info, crops, valid, blend_px,
                  splits=1):
    th, tw = tiles.shape[1:]
    shp = padded_canvas_shape(C, Z, H, W, th, tw)
    acc = jnp.zeros(shp, jnp.float32)
    wsum = jnp.zeros(shp, jnp.float32)
    for part in np.array_split(np.arange(len(tiles)), splits):
        acc, wsum = fuse_feather(acc, wsum, jnp.asarray(tiles[part]),
                                 jnp.asarray(info[part]),
                                 jnp.asarray(crops[part]),
                                 jnp.asarray(valid[part]), blend_px=blend_px)
    return np.asarray(finalize_feather(acc, wsum, jnp.uint16))[:, :, :H, :W]


def _assert_within_1lsb(got, expect):
    # f32 accumulation may contract multiply-add differently from NumPy
    diff = np.abs(got.astype(np.int64) - expect.astype(np.int64))
    assert diff.max() <= 1


def test_overwrite_matches_numpy_reference(rng):
    C, Z, H, W, th, tw = 2, 1, 96, 80, 32, 32
    prob = _problem(rng, C=C, Z=Z, H=H, W=W, th=th, tw=tw)
    np.testing.assert_array_equal(_fuse_overwrite(C, Z, H, W, *prob),
                                  overwrite_ref(C, Z, H, W, *prob))


def test_overwrite_larger_tiles_match_numpy_reference(rng):
    """64x64 tiles in a 160x144 canvas, fused across two calls."""
    C, Z, H, W, th, tw = 2, 1, 160, 144, 64, 64
    prob = _problem(rng, C=C, Z=Z, H=H, W=W, th=th, tw=tw)
    np.testing.assert_array_equal(
        _fuse_overwrite(C, Z, H, W, *prob, splits=2),
        overwrite_ref(C, Z, H, W, *prob))


def test_feather_matches_numpy_reference(rng):
    C, Z, H, W, th, tw = 2, 1, 128, 112, 32, 32
    prob = _problem(rng, n=14, C=C, Z=Z, H=H, W=W, th=th, tw=tw)
    expect = feather_ref(C, Z, H, W, *prob, blend_px=12)
    for splits in (1, 2):
        _assert_within_1lsb(
            _fuse_feather(C, Z, H, W, *prob, blend_px=12, splits=splits),
            expect)


def test_overwrite_order_later_tile_wins():
    """Overlapping tiles: the later one wins."""
    th = tw = 16
    tiles = np.stack([np.full((th, tw), 7, np.uint16),
                      np.full((th, tw), 9, np.uint16)])
    info = np.asarray([[0, 0, 0, 0], [0, 0, 4, 4]], np.int32)
    crops = np.zeros((2, 4), np.int32)
    valid = np.asarray([True, True])
    out = _fuse_overwrite(1, 1, 32, 32, tiles, info, crops, valid)
    assert out[0, 0, 8, 8] == 9
    assert out[0, 0, 0, 0] == 7
    np.testing.assert_array_equal(
        out, overwrite_ref(1, 1, 32, 32, tiles, info, crops, valid))


@pytest.mark.parametrize("splits", [1, 2])
def test_flatfield_overwrite_matches_numpy_reference(rng, splits):
    """apply_flatfield -> fuse_overwrite equals the corrected tiles
    slice-assigned by NumPy, byte for byte."""
    C, Z, H, W, th, tw = 2, 1, 160, 144, 64, 64
    tiles, info, crops, valid = _problem(rng, C=C, Z=Z, H=H, W=W,
                                         th=th, tw=tw)
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    corrected = np.asarray(apply_flatfield(
        jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(info[:, 0]),
        jnp.uint16))
    ref_tiles = correct_ref(tiles, ff, info[:, 0], np.uint16)
    np.testing.assert_array_equal(corrected, ref_tiles)
    np.testing.assert_array_equal(
        _fuse_overwrite(C, Z, H, W, corrected, info, crops, valid,
                        splits=splits),
        overwrite_ref(C, Z, H, W, ref_tiles, info, crops, valid))


@pytest.mark.parametrize("splits", [1, 2])
def test_flatfield_feather_matches_numpy_reference(rng, splits):
    """The correction quantizes to the dtype before the ramps."""
    C, Z, H, W, th, tw = 2, 1, 128, 112, 32, 32
    tiles, info, crops, valid = _problem(rng, n=14, C=C, Z=Z, H=H, W=W,
                                         th=th, tw=tw)
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    corrected = np.asarray(apply_flatfield(
        jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(info[:, 0]),
        jnp.uint16))
    ref_tiles = correct_ref(tiles, ff, info[:, 0], np.uint16)
    _assert_within_1lsb(
        _fuse_feather(C, Z, H, W, corrected, info, crops, valid,
                      blend_px=12, splits=splits),
        feather_ref(C, Z, H, W, ref_tiles, info, crops, valid, 12))


def test_flatfield_signed_dtype_matches_numpy_reference(rng):
    """int16 tiles: the correction clips to the dtype's FULL range
    (negatives survive)."""
    C, Z, H, W, th, tw = 1, 1, 96, 96, 32, 32
    n = 6
    tiles = rng.integers(-30000, 30000, (n, th, tw)).astype(np.int16)
    info = np.stack([np.zeros(n, int), np.zeros(n, int),
                     rng.integers(0, H, n), rng.integers(0, W, n)],
                    axis=1).astype(np.int32)
    crops = np.zeros((n, 4), np.int32)
    valid = np.ones((n,), bool)
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    corrected = np.asarray(apply_flatfield(
        jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(info[:, 0]),
        jnp.int16))
    ref_tiles = correct_ref(tiles, ff, info[:, 0], np.int16)
    np.testing.assert_array_equal(corrected, ref_tiles)
    got = _fuse_overwrite(C, Z, H, W, corrected, info, crops, valid,
                          dtype=np.int16)
    expect = overwrite_ref(C, Z, H, W, ref_tiles, info, crops, valid,
                           dtype=np.int16)
    assert expect.min() < 0  # negatives must be exercised
    np.testing.assert_array_equal(got, expect)


# -------------------------------------------------- unaligned cameras

@pytest.mark.parametrize("th,tw", [(50, 70), (100, 96), (96, 100),
                                   (120, 150)])
def test_unaligned_tiles_match_numpy_reference(rng, th, tw):
    """Tile extents that are neither powers of two nor multiples of 128
    (1000^2 / 1920x1200-class cameras, scaled down)."""
    C, Z, H, W = 2, 1, 3 * th - 7, 3 * tw - 5
    prob = _problem(rng, n=10, C=C, Z=Z, H=H, W=W, th=th, tw=tw)
    np.testing.assert_array_equal(_fuse_overwrite(C, Z, H, W, *prob),
                                  overwrite_ref(C, Z, H, W, *prob))


@pytest.mark.parametrize("th,tw", [(50, 70), (100, 96)])
def test_unaligned_flatfield_matches_numpy_reference(rng, th, tw):
    C, Z, H, W = 2, 1, 2 * th + 13, 2 * tw + 9
    tiles, info, crops, valid = _problem(rng, n=8, C=C, Z=Z, H=H, W=W,
                                         th=th, tw=tw)
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    corrected = np.asarray(apply_flatfield(
        jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(info[:, 0]),
        jnp.uint16))
    ref_tiles = correct_ref(tiles, ff, info[:, 0], np.uint16)
    np.testing.assert_array_equal(
        _fuse_overwrite(C, Z, H, W, corrected, info, crops, valid),
        overwrite_ref(C, Z, H, W, ref_tiles, info, crops, valid))


def test_unaligned_feather_matches_numpy_reference(rng):
    """Feather ramps on unaligned tiles follow the tile's crop window."""
    C, Z, th, tw = 1, 1, 60, 100
    H, W = 2 * th + 11, 2 * tw + 3
    prob = _problem(rng, n=8, C=C, Z=Z, H=H, W=W, th=th, tw=tw)
    _assert_within_1lsb(_fuse_feather(C, Z, H, W, *prob, blend_px=12),
                        feather_ref(C, Z, H, W, *prob, blend_px=12))
