"""BaSiC-style flatfield estimation on the accelerator.

The reference delegates to basicpy's ``BaSiC(get_darkfield=False,
smoothness_flatfield=1).fit(images)`` (stitcher.py:374-375). We implement
the same published shading model (Peng et al. 2017, "A BaSiC tool for
background and shading correction"): each sampled tile D_i is modeled as

    D_i = B_i * S + E_i

with S the smooth multiplicative flatfield (sparse in DCT domain), B_i a
per-tile baseline, and E_i a sparse residual (foreground objects). Fit by
ADMM; the DCT-domain prox is two dense matmuls with the orthonormal
DCT-II matrix, run at HIGHEST precision (a float32 product may otherwise
run in TF32 on the GPU). The whole solver is one jitted
``lax.fori_loop``; fitting runs at a fixed working resolution (basicpy
uses 128x128) and the flatfield is resized back to full tile size.

Working resolution: 96 (not basicpy's 128). The shading field is smooth
by construction (DCT-sparse), so the working size sets the solve's
cost, not its accuracy: the ground-truth sweep behind this choice is in
PERF.md (Findings, flatfield working size).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

WORKING_SIZE = 96

# ADMM penalty schedule, shared by the jitted solver and its NumPy twin.
# The solve converges once the terminal penalty mu0*rho^iters reaches
# ~1e2 (the soft thresholds 1/mu and lam/(mu*bsq) have shrunk to
# noise); (0.02, 1.3, 35) reaches the same terminal mu as the textbook
# (0.01, 1.1, 100) in a THIRD of the stack passes at the same
# ground-truth field error (PERF.md, Findings, ADMM schedule).
MU0 = 0.02
MU_RHO = 1.3
DEFAULT_MAX_ITERS = 35


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (C @ x == dct(x, norm='ortho'))."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def _soft(x, thresh):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - thresh, 0.0)


@functools.partial(jax.jit, static_argnames=('max_iters',))
def fit_flatfield_stack(images: jnp.ndarray, smoothness: float = 1.0,
                        max_iters: int = DEFAULT_MAX_ITERS) -> jnp.ndarray:
    """Fit the flatfield S (mean ~ 1) from a stack (N, h, w) float32.

    ADMM on  min ||E||_1 + lam*||DCT(S)||_1  s.t.  D_i = B_i*S + E_i.
    Returns S with unit mean, shape (h, w).
    """
    n, h, w = images.shape
    d = images.astype(jnp.float32)
    d_mean_per = jnp.mean(d, axis=(1, 2), keepdims=True)
    d = d / jnp.maximum(d_mean_per, 1e-6)          # normalize exposure
    C_h = jnp.asarray(dct_matrix(h))
    C_w = jnp.asarray(dct_matrix(w))

    hi = jax.lax.Precision.HIGHEST

    def dct2(x):
        return jnp.matmul(jnp.matmul(C_h, x, precision=hi), C_w.T,
                          precision=hi)

    def idct2(x):
        return jnp.matmul(jnp.matmul(C_h.T, x, precision=hi), C_w,
                          precision=hi)

    # DCT is orthonormal, and d is exposure-normalized to O(1) values, so
    # the smoothness weight applies directly as the L1 threshold scale.
    lam = smoothness

    # The iteration tracks z = y/mu (scaled multipliers) and hoists the
    # shared term w = d + z: with e' = soft(w - b*s, 1/mu) and
    # b' = max(<(w - e')·s>/<s·s>, 0), the multiplier update collapses to
    #   y' = y + mu*(d - b'*s - e') = mu*((w - e') - b'*s),
    # so z' = (mu/mu')*((w - e') - b'*s). Algebraically identical to the
    # textbook form, but each iteration touches the (N, h, w) stack far
    # fewer times — the solve is memory-bound (same rewrite in the numpy
    # twin below, kept in step-for-step correspondence, tested).
    s0 = jnp.mean(d, axis=0)
    state = (
        s0,                                  # S
        jnp.zeros_like(d),                   # E
        jnp.ones((n, 1, 1), jnp.float32),    # B
        jnp.zeros_like(d),                   # Z = Y/mu
        jnp.float32(MU0),                    # mu
    )

    def body(_, st):
        s, e, b, z, mu = st
        w_ = d + z
        # S update: least squares + DCT-L1 prox (orthonormal -> exact prox)
        bsq = jnp.sum(b * b) + 1e-6
        s_ls = jnp.sum(b * (w_ - e), axis=0) / bsq
        s = idct2(_soft(dct2(s_ls), lam / (mu * bsq)))
        # E update: elementwise soft threshold
        e = _soft(w_ - b * s, 1.0 / mu)
        # B update: per-image projection onto S (non-negative)
        v = w_ - e
        ssq = jnp.sum(s * s) + 1e-6
        b = jnp.maximum(jnp.sum(v * s, axis=(1, 2), keepdims=True) / ssq,
                        0.0)
        # Multiplier + penalty (see derivation above)
        mu_new = jnp.minimum(mu * MU_RHO, 1e6)
        z = (mu / mu_new) * (v - b * s)
        return (s, e, b, z, mu_new)

    s, *_ = jax.lax.fori_loop(0, max_iters, body, state)
    s = jnp.maximum(s, 1e-3)
    return s / jnp.mean(s)


def fit_flatfield_stack_np(images: np.ndarray, smoothness: float = 1.0,
                           max_iters: int = DEFAULT_MAX_ITERS) -> np.ndarray:
    """NumPy twin of :func:`fit_flatfield_stack` (identical iteration).

    The working-resolution solve is ~100 MFLOP; the host solver runs in
    well under a second. Kept in exact step-for-step correspondence with
    the jitted version (tested).
    """
    from scipy.fft import dctn, idctn
    n, h, w_ = images.shape
    d = images.astype(np.float32)
    d = d / np.maximum(d.mean(axis=(1, 2), keepdims=True), 1e-6)
    lam = smoothness

    def soft_small(x, t):
        return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)

    # Same z = y/mu iteration as the jitted twin, written for a
    # memory-bound host: every (N, h, w) op lands in a preallocated
    # buffer (out=), reductions against b/s run as one-pass GEMVs, and
    # the E soft threshold uses the exact identity
    #   soft(x, t) = x - clip(x, -t, t)
    # (case-identical in f32), which also hands v = w - e and the z
    # update the shared clip term:  v = b*s + cl,  z' = (mu/mu')*cl
    # since z' = (mu/mu')*(v - b'*s) with b' refit AFTER e. Net: ~26
    # stack passes/iteration vs ~47 for the naive form, iterates equal
    # to the jitted twin up to f32 reduction order (tested).
    s = d.mean(axis=0)
    e = np.zeros_like(d)
    z = np.zeros_like(d)
    b = np.ones(n, np.float32)
    # scratch stacks: w (= d + z), x (= w - b*s, also reused as u/v), and
    # the shared clip term; bs holds the b*s broadcast product
    w = np.empty_like(d)
    x = np.empty_like(d)
    cl = np.empty_like(d)
    bs = np.empty_like(d)
    mu = np.float32(MU0)
    for _ in range(max_iters):
        np.add(d, z, out=w)
        np.subtract(w, e, out=x)                     # u = w - e
        bsq = float(b @ b) + 1e-6
        s_ls = (b @ x.reshape(n, -1)).reshape(h, w_) / bsq
        s = idctn(soft_small(dctn(s_ls, norm='ortho'), lam / (mu * bsq)),
                  norm='ortho').astype(np.float32)
        np.multiply(b[:, None, None], s, out=bs)
        np.subtract(w, bs, out=x)                    # x = w - b*s
        thr = np.float32(1.0 / mu)
        np.clip(x, -thr, thr, out=cl)
        np.subtract(x, cl, out=e)                    # e = soft(x, 1/mu)
        np.add(bs, cl, out=x)                        # v = w - e = b*s + cl
        ssq = float(s.ravel() @ s.ravel()) + 1e-6
        b = np.maximum(x.reshape(n, -1) @ s.ravel() / ssq,
                       0.0).astype(np.float32)
        mu_new = np.float32(min(mu * MU_RHO, 1e6))
        np.multiply(b[:, None, None], s, out=bs)     # b'*s (refit b)
        np.subtract(x, bs, out=z)                    # v - b'*s
        z *= np.float32(mu / mu_new)
        mu = mu_new
    s = np.maximum(s, 1e-3)
    return (s / s.mean()).astype(np.float32)


def resize_stack(images: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize of (N, H, W) to (N, *size)."""
    n = images.shape[0]
    return jax.image.resize(images.astype(jnp.float32), (n,) + tuple(size),
                            method='linear')


def load_sample_small(path: str,
                      working_size: int = WORKING_SIZE) -> np.ndarray:
    """Read one sample tile decimated straight to working resolution.

    The fit happens at ``working_size``^2, so full-resolution decodes are
    pure waste. The mmap-backed reader + row decimation touch only every
    ``sy``-th row's pages; the final area resample runs on the small
    array. Returns (ws, ws) float32, or (ws, ws, 3) for RGB tiles.
    """
    from ..io.acquisition import read_image
    return decimate_to_working(read_image(path, prefer_mmap=True),
                               working_size)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-resampling matrix: output pixel i averages the
    input interval [i, i+1) * n_in/n_out, each input pixel weighted by
    the length it overlaps (OpenCV's INTER_AREA for downscaling)."""
    scale = n_in / n_out
    edges = np.arange(n_out + 1, dtype=np.float64) * scale
    j = np.arange(n_in, dtype=np.float64)[None, :]
    overlap = (np.minimum(edges[1:, None], j + 1)
               - np.maximum(edges[:-1, None], j))
    return np.clip(overlap, 0.0, None) / scale


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear-interpolation matrix with pixel centres
    aligned (src = (dst + 0.5) * n_in/n_out - 0.5, clamped at the
    borders; OpenCV's INTER_LINEAR)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    w = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


def _resize_separable(img: np.ndarray, out_h: int, out_w: int,
                      weights) -> np.ndarray:
    """Apply a separable resampling matrix to (H, W[, C]) float32."""
    wy = weights(img.shape[0], out_h).astype(np.float32)
    wx = weights(img.shape[1], out_w).astype(np.float32)
    out = np.tensordot(wy, img, axes=(1, 0))           # (oh, W[, C])
    out = np.tensordot(wx, out, axes=(1, 1))           # (ow, oh[, C])
    return np.ascontiguousarray(np.swapaxes(out, 0, 1))


def decimate_to_working(img: np.ndarray, working_size: int) -> np.ndarray:
    """(H, W[, 3]) image -> (ws, ws[, 3]) float32: stride-decimate
    toward ~2x the working size first (free; mmap-backed inputs fault
    only every sy-th row), then one area resample for the final step.
    The ONE sampling recipe every fit path (host and device) uses."""
    h, w = img.shape[:2]
    sy = max(1, h // (2 * working_size))
    sx = max(1, w // (2 * working_size))
    img = np.ascontiguousarray(img[::sy, ::sx]).astype(np.float32)
    return _resize_separable(img, working_size, working_size, _area_weights)


def finalize_flatfield(s: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Resize a working-resolution flatfield to full tile size (bilinear)
    and re-normalize to unit mean (shared tail of every fit path)."""
    full = _resize_separable(np.asarray(s, dtype=np.float32),
                             out_hw[0], out_hw[1], _linear_weights)
    full = np.maximum(full, 1e-3)
    return (full / full.mean()).astype(np.float32)


def fit_flatfield(tiles: np.ndarray, smoothness: float = 1.0,
                  working_size: int = WORKING_SIZE,
                  max_iters: int = DEFAULT_MAX_ITERS,
                  prefer_device: bool = False) -> np.ndarray:
    """Full-pipeline fit: (N, H, W) raw tiles -> (H, W) float32 flatfield.

    Mirrors the reference call (BaSiC fit on a sampled stack, flatfield
    applied at full tile resolution via division, stitcher.py:607-611).

    Down/up-sampling happens on the host (NumPy). The working-resolution
    solve defaults to the host NumPy solver (~100 MFLOP); set
    ``prefer_device=True`` (or shard the batch, parallel/sharded_ops) to
    run the jitted solver on the accelerator.
    """
    tiles = np.asarray(tiles)
    n, h, w = tiles.shape
    small = np.stack([decimate_to_working(t, working_size) for t in tiles])
    if prefer_device:
        s = np.asarray(fit_flatfield_stack(jnp.asarray(small),
                                           smoothness=smoothness,
                                           max_iters=max_iters))
    else:
        s = fit_flatfield_stack_np(small, smoothness=smoothness,
                                   max_iters=max_iters)
    return finalize_flatfield(s, (h, w))
