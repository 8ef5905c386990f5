"""Sharded canvas fusion: Y-band decomposition over the 'canvas' mesh axis.

Each device owns a horizontal band of the output canvas, stored as a
banded array (D, C, Z, band + 2*tile_h, W + tile_w) sharded on axis 0.
Tiles are replicated to every device; a device fuses only the slice of
each tile that intersects its own rows (out-of-band tiles mask to no-ops,
straddling tiles land partially in the top/bottom aprons, which are
discarded at finalize). No halo exchange and no collectives in the hot
loop — each output row has exactly one owner.

Feather blending shards the same way: the (acc, wsum) f32 pair is banded,
each band accumulates the rows it owns (ramps are computed on the whole
tile from its crops, so a straddler contributes identical weights to both
its bands), and the divide+cast finalize is per-band local — bit-equal to
the single-device feather path (tested).

This is the device-mesh replacement for the reference's multiprocessing
fan-out of disjoint zarr slice writes (zarr_stitcher.py:421-489).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.fuse import _feather_ramp, _tile_mask
from .mesh import AXIS_CANVAS, band_sharding


def band_local_origin(y, band: int, tile_h: int, band_start):
    """Band-local y origin + intersection flag (scalar or batched ``y``).

    Origins clamp to [0, band + tile_h] — the placement envelope of a
    band with one-tile aprons."""
    y_local = jnp.clip(y - band_start + tile_h, 0, band + tile_h)
    intersects = (y + tile_h > band_start) & (y < band_start + band)
    return y_local, intersects


class ShardedCanvas:
    """A (C, Z, H, W) canvas banded across the mesh 'canvas' axis."""

    def __init__(self, mesh: Mesh, num_c: int, num_z: int,
                 height: int, width: int, tile_h: int, tile_w: int, dtype,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 ff_recip=None):
        self.mesh = mesh
        self.n_bands = mesh.shape[AXIS_CANVAS]
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.band = -(-height // self.n_bands)  # ceil rows per band
        self.band_pad = self.band + 2 * tile_h
        self.dtype = np.dtype(dtype)
        self.blend = blend_method
        self.blend_px = blend_px
        # ff_recip ((C, th, tw) f32): applied per batch in fuse_batch, so
        # passing it is sufficient for corrected output
        self.ff_recip = ff_recip
        self._ff_device = None
        shape = (self.n_bands, num_c, num_z, self.band_pad,
                 width + tile_w)

        def banded_zeros(dt):
            # jit-init with out_shardings: zeros materialize directly in
            # their bands (no replicated host buffer), and this works
            # under multi-controller JAX where device_put from a host
            # value cannot target non-addressable devices.
            return jax.jit(lambda: jnp.zeros(shape, dt),
                           out_shardings=band_sharding(mesh))()

        if blend_method == 'feather':
            self.acc = banded_zeros(jnp.float32)
            self.wsum = banded_zeros(jnp.float32)
            self._fuse = self._build_fuse_feather()
        else:
            self.array = banded_zeros(dtype)
            self._fuse = self._build_fuse()

    def _band_local_pos(self, meta):
        """Band-local y origin + intersection flag for one tile (the
        scalar view of ``band_local_origin``)."""
        b = jax.lax.axis_index(AXIS_CANVAS)
        return band_local_origin(meta[2], self.band, self.tile_h,
                                 b * self.band)

    def _build_fuse(self):
        tile_h, tile_w = self.tile_h, self.tile_w
        mesh = self.mesh

        def local_fuse(canvas, tiles, info, crops, valid):
            # canvas: (1, C, Z, band_pad, Wp) local shard
            def body(cv, inp):
                tile, meta, crop, ok = inp
                c, z, x = meta[0], meta[1], meta[3]
                y_local, intersects = self._band_local_pos(meta)
                mask = _tile_mask(crop, tile_h, tile_w, ok & intersects)
                cur = jax.lax.dynamic_slice(
                    cv, (0, c, z, y_local, x), (1, 1, 1, tile_h, tile_w))
                upd = jnp.where(mask[None, None, None], tile[None, None, None], cur)
                cv = jax.lax.dynamic_update_slice(cv, upd, (0, c, z, y_local, x))
                return cv, None

            canvas, _ = jax.lax.scan(body, canvas, (tiles, info, crops, valid))
            return canvas

        fuse = shard_map(
            local_fuse, mesh=mesh,
            in_specs=(P(AXIS_CANVAS), P(), P(), P(), P()),
            out_specs=P(AXIS_CANVAS),
            check_vma=False)
        return jax.jit(fuse, donate_argnums=(0,))

    def _build_fuse_feather(self):
        tile_h, tile_w = self.tile_h, self.tile_w
        blend_px = self.blend_px
        mesh = self.mesh

        def local_fuse(acc, wsum, tiles, info, crops, valid):
            def body(carry, inp):
                a, w = carry
                tile, meta, crop, ok = inp
                c, z, x = meta[0], meta[1], meta[3]
                y_local, intersects = self._band_local_pos(meta)
                # ramp from the tile's full crop window — identical on
                # every band the tile touches (no boundary seams)
                ramp = _feather_ramp(crop, tile_h, tile_w, ok & intersects,
                                     blend_px)
                cur_a = jax.lax.dynamic_slice(
                    a, (0, c, z, y_local, x), (1, 1, 1, tile_h, tile_w))
                cur_w = jax.lax.dynamic_slice(
                    w, (0, c, z, y_local, x), (1, 1, 1, tile_h, tile_w))
                new_a = cur_a + (ramp * tile.astype(jnp.float32))[None, None, None]
                new_w = cur_w + ramp[None, None, None]
                a = jax.lax.dynamic_update_slice(a, new_a, (0, c, z, y_local, x))
                w = jax.lax.dynamic_update_slice(w, new_w, (0, c, z, y_local, x))
                return (a, w), None

            (acc, wsum), _ = jax.lax.scan(body, (acc, wsum),
                                          (tiles, info, crops, valid))
            return acc, wsum

        fuse = shard_map(
            local_fuse, mesh=mesh,
            in_specs=(P(AXIS_CANVAS), P(AXIS_CANVAS), P(), P(), P(), P()),
            out_specs=(P(AXIS_CANVAS), P(AXIS_CANVAS)),
            check_vma=False)
        return jax.jit(fuse, donate_argnums=(0, 1))

    def fuse_batch(self, tiles: jnp.ndarray, info: jnp.ndarray,
                   crops: jnp.ndarray, valid: jnp.ndarray):
        """Fuse a replicated batch; tiles (N, th, tw), info (N,4) [c,z,y,x].

        When ``ff_recip`` was given, tiles arrive RAW and are corrected
        here with a batched apply_flatfield."""
        if self.ff_recip is not None:
            from ..ops.fuse import apply_flatfield
            if self._ff_device is None:
                self._ff_device = jnp.asarray(self.ff_recip, jnp.float32)
            tiles = apply_flatfield(tiles, self._ff_device, info[:, 0],
                                    self.dtype)
        if self.blend == 'feather':
            self.acc, self.wsum = self._fuse(self.acc, self.wsum, tiles,
                                             info, crops, valid)
        else:
            self.array = self._fuse(self.array, tiles, info, crops, valid)

    @functools.cached_property
    def _finalize(self):
        th = self.tile_h

        def assemble(banded):
            d, c, z, bp, wp = banded.shape
            core = banded[:, :, :, th:th + self.band, :]
            out = jnp.transpose(core, (1, 2, 0, 3, 4)).reshape(
                c, z, d * self.band, wp)
            return out[:, :, :self.height, :self.width]

        if self.blend == 'feather':
            from ..ops.fuse import finalize_feather
            out_dtype = self.dtype

            @jax.jit
            def fin(acc, wsum):
                # per-band divide+cast is local (each row has one owner
                # accumulating it), then assemble
                return assemble(finalize_feather(acc, wsum, out_dtype))

            return fin
        return jax.jit(assemble)

    def finalize(self) -> jnp.ndarray:
        """Assemble the (C, Z, H, W) canvas (device-resident)."""
        if self.blend == 'feather':
            return self._finalize(self.acc, self.wsum)
        return self._finalize(self.array)
