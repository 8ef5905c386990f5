"""Native host kernels must be byte-identical to the NumPy path."""

import numpy as np
import pytest

from image_stitcher_tpu import native
from image_stitcher_tpu.ops.host_fuse import HostCanvas


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C compiler available")
    return lib


def run_canvas(use_native, rng, dtype=np.uint16, blend='overwrite', ff=True):
    import image_stitcher_tpu.native as nat
    saved = (nat._LIB, nat._TRIED)
    if not use_native:
        nat._LIB, nat._TRIED = None, True
    try:
        flat = (np.full((2, 24, 24), np.float32(1.0) / np.float32(1.3),
                        np.float32) if ff else None)
        hc = HostCanvas(2, 1, 100, 90, dtype, num_threads=2,
                        ff_recip=flat, blend_method=blend, blend_px=8)
        r = np.random.default_rng(7)
        for i in range(30):
            tile = r.integers(0, np.iinfo(dtype).max, (24, 24), dtype=dtype)
            c = int(r.integers(0, 2))
            y, x = int(r.integers(0, 95)), int(r.integers(0, 85))
            crops = tuple(int(v) for v in r.integers(0, 5, 4))
            hc._place((tile, c, 0, y, x, crops))
        return hc.finalize()
    finally:
        nat._LIB, nat._TRIED = saved


def test_native_builds(lib):
    assert lib is not None


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("ff", [True, False])
def test_native_overwrite_identical(lib, rng, dtype, ff):
    a = run_canvas(True, rng, dtype=dtype, ff=ff)
    b = run_canvas(False, rng, dtype=dtype, ff=ff)
    np.testing.assert_array_equal(a, b)


def test_native_feather_close(lib, rng):
    a = run_canvas(True, rng, blend='feather')
    b = run_canvas(False, rng, blend='feather')
    # f32 accumulation order identical; results must match to the bit
    np.testing.assert_array_equal(a, b)


def test_native_speedup(lib):
    """Native path should not be slower than NumPy on the hot shape."""
    import time
    r = np.random.default_rng(0)
    tile = r.integers(0, 65535, (2048, 2048), dtype=np.uint16)
    ff = np.full((1, 2048, 2048), 1.0 / 1.1, np.float32)

    def bench(use_native, n=6):
        import image_stitcher_tpu.native as nat
        saved = (nat._LIB, nat._TRIED)
        if not use_native:
            nat._LIB, nat._TRIED = None, True
        try:
            hc = HostCanvas(1, 1, 4096, 4096, np.uint16, ff_recip=ff)
            t0 = time.perf_counter()
            for i in range(n):
                hc._place((tile, 0, 0, (i * 640) % 2000, 13, (0, 0, 0, 0)))
            return time.perf_counter() - t0
        finally:
            nat._LIB, nat._TRIED = saved

    bench(True, 1)  # warm build
    t_native = bench(True)
    t_numpy = bench(False)
    assert t_native < t_numpy * 1.2, (t_native, t_numpy)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (3, 2, 33, 65),
                                   (2, 5), (1, 1)])
def test_downsample2x_native_matches_numpy(lib, rng, dtype, shape):
    """The C stride-2 gather must copy exactly the elements the NumPy
    slice copies, across odd shapes, leading dims, and both dtypes."""
    from image_stitcher_tpu.ops.host_fuse import _downsample2x_native
    x = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    h2, w2 = (shape[-2] // 2) * 2, (shape[-1] // 2) * 2
    expected = np.ascontiguousarray(x[..., :h2:2, :w2:2])
    got = _downsample2x_native(x, h2 // 2, w2 // 2)
    if h2 == 0 or w2 == 0:
        assert got is None  # NumPy fallback handles empties
        return
    assert got is not None
    assert got.dtype == expected.dtype and got.shape == expected.shape
    assert (got == expected).all()


def test_downsample2x_native_declines_unsupported(lib, rng):
    from image_stitcher_tpu.ops.host_fuse import _downsample2x_native
    f = rng.random((16, 16)).astype(np.float32)
    assert _downsample2x_native(f, 8, 8) is None  # dtype
    x = rng.integers(0, 99, (16, 16)).astype(np.uint16)
    assert _downsample2x_native(x[:, ::2], 8, 4) is None  # strided cols


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (2, 3, 33, 65)])
def test_downsample2x2_mean_native_matches_numpy(lib, rng, dtype, shape):
    """The integer mean kernel must equal the NumPy float32 path
    bit-for-bit: the 4-term sum is < 2^24 (exact in f32) and /4 is a
    power of two, so floor(f32 mean) == sum >> 2."""
    from image_stitcher_tpu.ops.host_fuse import _downsample2x_native
    x = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    # saturate some windows to the dtype max to exercise the carry
    x[..., :2, :2] = np.iinfo(dtype).max
    h2, w2 = (shape[-2] // 2) * 2, (shape[-1] // 2) * 2
    t = x[..., :h2, :w2].astype(np.float32)
    lead = t.shape[:-2]
    expected = np.floor(
        t.reshape(lead + (h2 // 2, 2, w2 // 2, 2)).mean(axis=(-3, -1))
    ).astype(dtype)
    got = _downsample2x_native(x, h2 // 2, w2 // 2, 'mean')
    assert got is not None
    assert got.dtype == expected.dtype and got.shape == expected.shape
    assert (got == expected).all()


def test_finalize_feather_native_matches_numpy():
    """Native single-pass finalize is bit-identical to the NumPy chain
    for both dtypes, all supported leading shapes, and the wsum==0 /
    clip edges (the hot path of host feather blending)."""
    import numpy as np
    from image_stitcher_tpu.ops.host_fuse import finalize_feather_host
    import image_stitcher_tpu.native as nat
    rng = np.random.default_rng(3)
    for shape in [(2, 130, 257), (64, 64), (1, 1, 33, 500)]:
        acc = (rng.random(shape, np.float32) * 70000).astype(np.float32)
        wsum = (rng.random(shape, np.float32) * 2).astype(np.float32)
        wsum[rng.random(shape) < 0.15] = 0.0
        # exact half values exercise round-half-to-even
        acc.flat[::7] = 1.5
        wsum.flat[::7] = 1.0
        for dtype, maxv in ((np.uint16, 65535), (np.uint8, 255)):
            ref = acc / np.maximum(wsum, 1e-6)
            ref[wsum == 0] = 0
            ref = np.clip(np.round(ref), 0, maxv).astype(dtype)
            got = finalize_feather_host(acc, wsum, dtype)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(ref, got), (shape, dtype)
            # and the forced-NumPy fallback agrees too
            saved = nat._LIB, nat._TRIED
            nat._LIB, nat._TRIED = None, True
            try:
                np.testing.assert_array_equal(
                    ref, finalize_feather_host(acc, wsum, dtype))
            finally:
                nat._LIB, nat._TRIED = saved
