"""Multi-device tests on the 8-virtual-CPU-device backend (conftest)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from image_stitcher_tpu.parallel.mesh import (make_mesh, default_mesh_shape,
                                              AXIS_CANVAS, AXIS_DATA)
from image_stitcher_tpu.parallel.sharded_fuse import ShardedCanvas
from image_stitcher_tpu.parallel.sharded_ops import (
    sharded_phase_cross_correlation, sharded_apply_flatfield)
from image_stitcher_tpu.ops.fuse import fuse_overwrite, padded_canvas_shape


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    mesh = make_mesh((2, 4))
    assert mesh.shape[AXIS_DATA] == 2 and mesh.shape[AXIS_CANVAS] == 4
    assert default_mesh_shape(8) == (2, 4)
    assert default_mesh_shape(7) == (1, 7)
    with pytest.raises(ValueError):
        make_mesh((3, 4))


def _random_problem(rng, n_tiles=24, C=2, Z=2, H=100, W=80, th=32, tw=32):
    tiles = rng.integers(0, 65535, (n_tiles, th, tw), dtype=np.uint16)
    info = np.stack([
        rng.integers(0, C, n_tiles),
        rng.integers(0, Z, n_tiles),
        rng.integers(0, H - 8, n_tiles),   # includes band-straddling rows
        rng.integers(0, W - 8, n_tiles),
    ], axis=1).astype(np.int32)
    crops = rng.integers(0, 5, (n_tiles, 4)).astype(np.int32)
    valid = rng.random(n_tiles) > 0.1
    return tiles, info, crops, valid


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (1, 3)])
def test_sharded_fuse_matches_single_device(mesh_shape, rng):
    C, Z, H, W, th, tw = 2, 2, 100, 80, 32, 32
    tiles, info, crops, valid = _random_problem(rng)
    # single-device reference
    cv = jnp.zeros(padded_canvas_shape(C, Z, H, W, th, tw), jnp.uint16)
    cv = fuse_overwrite(cv, jnp.asarray(tiles), jnp.asarray(info),
                        jnp.asarray(crops), jnp.asarray(valid))
    expect = np.asarray(cv)[:, :, :H, :W]

    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, jax.devices()[:n_dev])
    canvas = ShardedCanvas(mesh, C, Z, H, W, th, tw, jnp.uint16)
    canvas.fuse_batch(jnp.asarray(tiles), jnp.asarray(info),
                      jnp.asarray(crops), jnp.asarray(valid))
    got = np.asarray(canvas.finalize())
    np.testing.assert_array_equal(got, expect)


def test_sharded_fuse_multiple_batches(rng):
    C, Z, H, W, th, tw = 1, 1, 64, 64, 16, 16
    mesh = make_mesh((1, 4), jax.devices()[:4])
    canvas = ShardedCanvas(mesh, C, Z, H, W, th, tw, jnp.uint16)
    cv = jnp.zeros(padded_canvas_shape(C, Z, H, W, th, tw), jnp.uint16)
    for seed in range(3):
        r = np.random.default_rng(seed)
        tiles, info, crops, valid = _random_problem(r, n_tiles=8, C=C, Z=Z,
                                                    H=H, W=W, th=th, tw=tw)
        canvas.fuse_batch(jnp.asarray(tiles), jnp.asarray(info),
                          jnp.asarray(crops), jnp.asarray(valid))
        cv = fuse_overwrite(cv, jnp.asarray(tiles), jnp.asarray(info),
                            jnp.asarray(crops), jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(canvas.finalize()),
                                  np.asarray(cv)[:, :, :H, :W])


def test_sharded_phasecorr_matches(rng):
    from image_stitcher_tpu.ops.phasecorr import phase_cross_correlation_batch
    mesh = make_mesh((4, 2), jax.devices())
    a = rng.random((8, 48, 64)).astype(np.float32)
    b = np.roll(a, (3, -2), axis=(1, 2))
    single = np.asarray(phase_cross_correlation_batch(
        jnp.asarray(a), jnp.asarray(b), 10))
    sharded = np.asarray(sharded_phase_cross_correlation(
        mesh, jnp.asarray(a), jnp.asarray(b), 10))
    np.testing.assert_allclose(sharded, single, atol=1e-3)
    # roll displaces content by (3,-2); pcc returns the registering shift,
    # its negation
    np.testing.assert_allclose(single, np.tile([[-3, 2]], (8, 1)), atol=0.1)


def test_sharded_flatfield_apply(rng):
    mesh = make_mesh((4, 2), jax.devices())
    tiles = rng.integers(0, 65535, (8, 16, 16), dtype=np.uint16)
    ff = np.full((2, 16, 16), 0.5, np.float32)  # reciprocal field: /2
    cidx = np.zeros(8, np.int32)
    out = np.asarray(sharded_apply_flatfield(
        mesh, jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(cidx),
        jnp.uint16))
    np.testing.assert_array_equal(out, (tiles / 2.0).astype(np.uint16))


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    canvas, shift = out
    assert canvas.ndim == 4 and shift.shape == (2,)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_graft_entry_dryrun_multichip(n):
    import __graft_entry__ as ge
    ge.dryrun_multichip(n)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_flatfield_matches_numpy_reference(mesh_shape, rng):
    """A banded canvas given RAW tiles and ff_recip must equal the
    corrected tiles slice-assigned by NumPy, byte for byte."""
    from test_fuse_reference import correct_ref, overwrite_ref
    C, Z, H, W, th, tw = 2, 2, 100, 80, 32, 32
    tiles, info, crops, valid = _random_problem(rng)
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    expect = overwrite_ref(C, Z, H, W,
                           correct_ref(tiles, ff, info[:, 0], np.uint16),
                           info, crops, valid)

    mesh = make_mesh(mesh_shape)
    canvas = ShardedCanvas(mesh, C, Z, H, W, th, tw, np.uint16,
                           ff_recip=ff)
    canvas.fuse_batch(jnp.asarray(tiles), jnp.asarray(info),
                      jnp.asarray(crops), jnp.asarray(valid))
    got = np.asarray(canvas.finalize())
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_feather_flatfield_matches_numpy_reference(mesh_shape, rng):
    """Banded FEATHER with ff_recip against the NumPy feather reference
    on the corrected tiles."""
    from test_fuse_reference import correct_ref, feather_ref
    C, Z, H, W, th, tw = 2, 1, 100, 80, 32, 32
    tiles, info, crops, valid = _random_problem(rng, C=C, Z=Z)
    info[:, 1] = 0
    ff = (rng.random((C, th, tw)) * 0.8 + 0.6).astype(np.float32)
    expect = feather_ref(C, Z, H, W,
                         correct_ref(tiles, ff, info[:, 0], np.uint16),
                         info, crops, valid, blend_px=12)

    mesh = make_mesh(mesh_shape)
    canvas = ShardedCanvas(mesh, C, Z, H, W, th, tw, np.uint16,
                           blend_method='feather', blend_px=12,
                           ff_recip=ff)
    canvas.fuse_batch(jnp.asarray(tiles), jnp.asarray(info),
                      jnp.asarray(crops), jnp.asarray(valid))
    got = np.asarray(canvas.finalize())
    diff = np.abs(got.astype(int) - expect.astype(int))
    assert diff.max() <= 1  # f32 accumulation order across bands
