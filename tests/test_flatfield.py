import numpy as np
import pytest

from image_stitcher_tpu.ops.flatfield import (
    fit_flatfield, fit_flatfield_stack, dct_matrix, resize_stack)

from fixtures import make_ground_truth


def make_vignette(h, w, strength=0.4):
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2
    v = 1.0 - strength * r2 / r2.max()
    return (v / v.mean()).astype(np.float32)


def test_dct_matrix_orthonormal():
    c = dct_matrix(32)
    np.testing.assert_allclose(c @ c.T, np.eye(32), atol=1e-5)


def test_dct_matches_scipy():
    from scipy.fft import dct
    x = np.random.default_rng(0).random(16).astype(np.float32)
    c = dct_matrix(16)
    np.testing.assert_allclose(c @ x, dct(x, norm='ortho'), atol=1e-5)


def test_resize_stack_shape():
    out = resize_stack(np.ones((3, 40, 60), np.float32), (128, 128))
    assert out.shape == (3, 128, 128)
    np.testing.assert_allclose(np.asarray(out), 1.0, atol=1e-5)


def test_recovers_synthetic_vignette():
    """Tiles = random scenes * known vignette; fitted flatfield must
    correlate strongly with the vignette and correct it."""
    rng = np.random.default_rng(7)
    h = w = 96
    vign = make_vignette(h, w, strength=0.5)
    tiles = []
    for i in range(24):
        scene = np.asarray(make_ground_truth(h, w, seed=100 + i), np.float32)
        tiles.append(scene * vign)
    tiles = np.stack(tiles)
    ff = fit_flatfield(tiles, smoothness=1.0, working_size=64, max_iters=120)
    assert ff.shape == (h, w)
    assert ff.mean() == pytest.approx(1.0, abs=1e-3)
    # Dense-texture scenes share correlated low-frequency content, which
    # bounds any shading estimator; the sparse-foreground test below is the
    # realistic microscopy case and holds a tighter bar.
    corr = np.corrcoef(ff.ravel(), vign.ravel())[0, 1]
    assert corr > 0.9
    # Correcting a vignetted flat image should flatten it substantially.
    flat_scene = np.full((h, w), 1000.0, np.float32) * vign
    corrected = flat_scene / ff
    cv_before = flat_scene.std() / flat_scene.mean()
    cv_after = corrected.std() / corrected.mean()
    assert cv_after < cv_before * 0.5


def test_uniform_stack_gives_unit_flatfield():
    tiles = np.full((8, 64, 64), 500.0, np.float32)
    ff = fit_flatfield(tiles, working_size=32, max_iters=60)
    np.testing.assert_allclose(ff, 1.0, atol=0.02)


def test_flatfield_robust_to_sparse_foreground():
    """Bright sparse blobs (cells) shouldn't drag the flatfield."""
    rng = np.random.default_rng(3)
    h = w = 64
    vign = make_vignette(h, w, strength=0.5)
    tiles = []
    for i in range(24):
        scene = np.full((h, w), 800.0, np.float32)
        # sparse bright spots at random positions
        for _ in range(4):
            y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
            scene[y - 2:y + 2, x - 2:x + 2] = 8000.0
        tiles.append(scene * vign)
    ff = fit_flatfield(np.stack(tiles), working_size=64, max_iters=150)
    corr = np.corrcoef(ff.ravel(), vign.ravel())[0, 1]
    assert corr > 0.95


def test_default_working_size_ground_truth_accuracy():
    """Pin the default working resolution's ground-truth accuracy.

    WORKING_SIZE is 96 because a ground-truth sweep showed the smooth
    (DCT-sparse) field's accuracy is set by the model, not the grid
    (PERF.md, Findings, flatfield working size). This bounds
    the same metric at the DEFAULT size on a scaled-down fixture so a
    future size change must re-prove accuracy, not just speed."""
    from image_stitcher_tpu.ops.flatfield import (
        WORKING_SIZE, decimate_to_working, finalize_flatfield,
        fit_flatfield_stack_np)
    rng = np.random.default_rng(11)
    h = w = 512
    vign = make_vignette(h, w, strength=0.45)
    tiles = []
    for i in range(16):
        img = np.full((h, w), float(rng.uniform(300, 800)), np.float32)
        for _ in range(rng.integers(2, 7)):   # sparse foreground blobs
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            r = int(rng.integers(10, 60))
            ys, ye = max(0, y - r), min(h, y + r)
            xs, xe = max(0, x - r), min(w, x + r)
            yy, xx = np.mgrid[ys:ye, xs:xe]
            img[ys:ye, xs:xe] += float(rng.uniform(2000, 20000)) * np.exp(
                -(((yy - y) ** 2 + (xx - x) ** 2) / (0.3 * r * r + 1)))
        img *= vign
        img += rng.normal(0, 25, (h, w))
        tiles.append(np.clip(img, 0, 65535).astype(np.uint16))
    small = np.stack([decimate_to_working(t, WORKING_SIZE) for t in tiles])
    full = finalize_flatfield(fit_flatfield_stack_np(small), (h, w))
    err = np.abs(full / (vign / vign.mean()) - 1.0).mean()
    assert err < 0.012, f"default-size GT field error too high: {err:.5f}"


def test_pooled_channel_fits_match_sequential(tmp_path, monkeypatch):
    """compute_flatfields dispatches channel fits to a thread pool on
    multi-core hosts, submitting each fit AS its sample stack loads
    (bounded in-flight stacks). The pooled path must produce the same
    flatfields as the 1-core sequential path, for every channel."""
    from fixtures import write_synthetic_acquisition

    from image_stitcher_tpu.models.pipeline import StitchPipeline
    from image_stitcher_tpu.params import EngineOptions, StitchingParameters

    acq_dir = str(tmp_path / "acq")
    chans = [f"Fluorescence {nm} nm Ex" for nm in (405, 488, 561, 638, 730)]
    write_synthetic_acquisition(
        acq_dir, grid_cols=3, grid_rows=3, tile_w=96, tile_h=96,
        overlap=16, channels=chans,
        vignette=make_vignette(96, 96))

    def fields(cpus):
        import image_stitcher_tpu.models.pipeline as pipe_mod
        monkeypatch.setattr(pipe_mod, "_available_cpus", lambda: cpus,
                            raising=False)
        # the import inside _compute_flatfields_inner resolves from
        # params at call time — patch there too
        import image_stitcher_tpu.params as params_mod
        monkeypatch.setattr(params_mod, "_available_cpus", lambda: cpus)
        from image_stitcher_tpu.io.acquisition import scan_acquisition
        p = StitchPipeline(
            StitchingParameters(input_folder=acq_dir, apply_flatfield=True),
            EngineOptions(flatfield_device='host'))
        p.acq = scan_acquisition(acq_dir)
        p.compute_flatfields()
        assert sorted(p.flatfields) == list(range(len(chans)))
        return {i: np.asarray(f) for i, f in p.flatfields.items()}

    seq = fields(1)
    pooled = fields(4)
    for i in seq:
        np.testing.assert_allclose(pooled[i], seq[i], rtol=0, atol=0)


def test_buffered_np_solver_matches_naive_textbook_form():
    """The buffered fit (out= buffers, GEMV reductions, clip-form soft
    threshold) must produce the same iterates as a straightforward
    transcription of the same scaled-multiplier iteration — guards the
    in-place rewrite against buffer-aliasing bugs. soft(x, t) and
    x - clip(x, -t, t) are case-identical in f32, so only reduction
    order (BLAS vs np.sum) may differ."""
    from scipy.fft import dctn, idctn

    from image_stitcher_tpu.ops.flatfield import (MU0, MU_RHO,
                                                  fit_flatfield_stack_np)

    def naive(images, smoothness=1.0, max_iters=35):
        n, h, w = images.shape
        d = images.astype(np.float32)
        d = d / np.maximum(d.mean(axis=(1, 2), keepdims=True), 1e-6)
        lam = smoothness

        def soft(x, t):
            return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)

        s = d.mean(axis=0)
        e = np.zeros_like(d)
        b = np.ones((n, 1, 1), np.float32)
        z = np.zeros_like(d)
        mu = np.float32(MU0)
        for _ in range(max_iters):
            w_ = d + z
            u = w_ - e
            bsq = float((b * b).sum()) + 1e-6
            s_ls = (b * u).sum(axis=0) / bsq
            s = idctn(soft(dctn(s_ls, norm='ortho'), lam / (mu * bsq)),
                      norm='ortho').astype(np.float32)
            e = soft(w_ - b * s, 1.0 / mu)
            v = w_ - e
            ssq = float((s * s).sum()) + 1e-6
            b = np.maximum((v * s).sum(axis=(1, 2), keepdims=True)
                           / ssq, 0.0).astype(np.float32)
            mu_new = np.float32(min(mu * MU_RHO, 1e6))
            z = (mu / mu_new) * (v - b * s)
            mu = mu_new
        s = np.maximum(s, 1e-3)
        return (s / s.mean()).astype(np.float32)

    rng = np.random.default_rng(3)
    vign = make_vignette(64, 64)
    stack = ((rng.random((16, 64, 64)).astype(np.float32) + 0.4)
             * vign)
    got = fit_flatfield_stack_np(stack, max_iters=35)
    want = naive(stack, max_iters=35)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ------------------------------------------- NumPy resampling (no OpenCV)

@pytest.mark.parametrize("n_in,n_out", [(205, 96), (96, 96), (48, 96)])
def test_area_weights_preserve_mean(n_in, n_out):
    from image_stitcher_tpu.ops.flatfield import _area_weights
    w = _area_weights(n_in, n_out)
    assert w.shape == (n_out, n_in)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-12)
    # every input pixel carries the same total weight
    np.testing.assert_allclose(w.sum(axis=0), n_out / n_in, atol=1e-12)


@pytest.mark.parametrize("n_in,n_out", [(96, 2048), (96, 1000)])
def test_linear_weights_interpolate(n_in, n_out):
    from image_stitcher_tpu.ops.flatfield import _linear_weights
    w = _linear_weights(n_in, n_out)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-12)
    ramp = np.arange(n_in, dtype=np.float64)
    out = w @ ramp
    # pixel-centre alignment: interior outputs sit on the input ramp
    src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    inner = (src >= 0) & (src <= n_in - 1)
    np.testing.assert_allclose(out[inner], src[inner], atol=1e-9)


@pytest.mark.parametrize("shape", [(2048, 2048), (100, 60), (300, 200, 3)])
def test_decimate_to_working_shape_and_mean(shape):
    from image_stitcher_tpu.ops.flatfield import decimate_to_working
    rng = np.random.default_rng(0)
    flat = np.full(shape, 1234, np.uint16)
    out = decimate_to_working(flat, 96)
    assert out.shape == (96, 96) + shape[2:] and out.dtype == np.float32
    np.testing.assert_allclose(out, 1234.0, rtol=1e-6)
    img = rng.random(shape).astype(np.float32)
    small = decimate_to_working(img, 96)
    assert abs(small.mean() - img.mean()) < 0.01


def test_finalize_flatfield_shape_and_unit_mean():
    from image_stitcher_tpu.ops.flatfield import finalize_flatfield
    s = make_vignette(96, 96)
    full = finalize_flatfield(s, (2048, 1500))
    assert full.shape == (2048, 1500) and full.dtype == np.float32
    assert full.mean() == pytest.approx(1.0, abs=1e-5)
    # the smooth field keeps its shape through the bilinear upsample
    assert np.corrcoef(full[::16, ::16].ravel(),
                       make_vignette(2048, 1500)[::16, ::16].ravel())[0, 1] > 0.99
